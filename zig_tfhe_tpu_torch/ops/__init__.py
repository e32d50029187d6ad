# blind_rotate, blind_rotate_ntt and split_ring load with key.py and
# bootstrap.py: they import trgsw.py, which imports this package.
from zig_tfhe_tpu_torch.ops import poly
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops import decomposition
from zig_tfhe_tpu_torch.ops import keyswitch
from zig_tfhe_tpu_torch.ops import packing_keyswitch
