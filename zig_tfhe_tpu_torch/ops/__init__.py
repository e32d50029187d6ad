from zig_tfhe_tpu_torch.ops import poly
from zig_tfhe_tpu_torch.ops import ntt
from zig_tfhe_tpu_torch.ops import decomposition
from zig_tfhe_tpu_torch.ops import blind_rotate
from zig_tfhe_tpu_torch.ops import blind_rotate_ntt
from zig_tfhe_tpu_torch.ops import keyswitch
from zig_tfhe_tpu_torch.ops import packing_keyswitch
