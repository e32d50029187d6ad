from zig_tfhe_tpu_torch.utils import torus
from zig_tfhe_tpu_torch.utils import rng
from zig_tfhe_tpu_torch.utils import serialization
