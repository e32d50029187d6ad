from zig_tfhe_tpu_torch.parallel import mesh
from zig_tfhe_tpu_torch.parallel import distributed
