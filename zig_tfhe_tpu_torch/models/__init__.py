from zig_tfhe_tpu_torch.models import gates
from zig_tfhe_tpu_torch.models import netlists
from zig_tfhe_tpu_torch.models import circuits
from zig_tfhe_tpu_torch.models import scheduler
from zig_tfhe_tpu_torch.models import lut
from zig_tfhe_tpu_torch.models import integer
from zig_tfhe_tpu_torch.models import proxy_reenc
