"""The blind-rotation step's finishing kernel (inverse NTT + CRT lift +
accumulate): its plain PyTorch version against the TPU kernel it replaces,
zig_tfhe_tpu/ops/pallas/ntt_inverse.py:ntt_inverse_to_crt_pallas, run in
Pallas's TPU interpret mode on the CPU.  The hand-written CUDA kernel is
held against the plain version in tests/test_torch_cuda.py.

Residues are the forward NTT of bounded polynomials (the CRT lift is
exact only below P/4), so the expected output is also known in closed
form: acc + (c << drop).  Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.ops import ntt as jntt
from zig_tfhe_tpu.ops.pallas.ntt_inverse import ntt_inverse_to_crt_pallas
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.ops import ntt as tntt
from zig_tfhe_tpu_torch.ops.cuda import ntt_inverse as K

# (name, drop, group, levels, engine bgbit)
_CASES = {"tiny": ("tiny", 0, 3, (2, 2), 6), "128bit": ("128bit", 5, 3, (2, 2), 7)}


def _inputs(case, B, seed):
    name, drop, group, levels, bgbit = _CASES[case]
    kw = dict(bgbit=bgbit, pseudorandom_key=True)
    jplan = jntt.plan_for_params(JP.PARAMS_BY_NAME[name], drop, group, levels, **kw)
    tplan = tntt.plan_for_params(TP.PARAMS_BY_NAME[name], drop, group, levels, **kw)
    rng = np.random.default_rng(seed)
    c = rng.integers(-2**31, 2**31, (B, 2, jplan.N)).astype(np.int32)
    acc = rng.integers(-2**31, 2**31, (B, 2, jplan.N)).astype(np.int32)
    v = np.stack([np.asarray(r) for r in
                  jntt.ntt_forward(jnp.asarray(c), jplan, 4, 128)])
    exact = (acc.astype(np.int64) + (c.astype(np.int64) << drop)).astype(np.int32)
    return jplan, tplan, drop, v, acc, exact


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reference_matches_pallas_interpret(case):
    jplan, tplan, drop, v, acc, exact = _inputs(case, 8, 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ntt_inverse_to_crt_pallas(
            jnp.asarray(v), jnp.asarray(acc), jplan, drop))
    got = K.ntt_inverse_to_crt_acc_reference(
        torch.from_numpy(v), torch.from_numpy(acc), tplan, drop).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, exact)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_wrapper_runs_plain_version_on_cpu(case):
    """CPU tensors take the plain version (no launch is counted), at a
    batch the Pallas kernel's B % 128 rule would refuse."""
    _, tplan, drop, v, acc, exact = _inputs(case, 3, 2)
    before = K.ntt_inverse_to_crt_acc.launches
    got = K.ntt_inverse_to_crt_acc(torch.from_numpy(v), torch.from_numpy(acc),
                                   tplan, drop).numpy()
    assert np.array_equal(got, exact)
    assert K.ntt_inverse_to_crt_acc.launches == before
    with pytest.raises(NotImplementedError):
        K.ntt_inverse_to_crt_acc(torch.from_numpy(v).long(),
                                 torch.from_numpy(acc).long(), tplan, drop)
