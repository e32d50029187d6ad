from zig_tfhe_tpu_torch.models import gates
