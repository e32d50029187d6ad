"""The plain reference: truth tables and the judging of ciphertexts."""

import numpy as np
import pytest

from gpubench.reference import gates as ref

LOGIC = {"nand": lambda p, q: not (p and q), "or": lambda p, q: p or q,
         "and": lambda p, q: p and q, "xor": lambda p, q: p != q,
         "xnor": lambda p, q: p == q, "nor": lambda p, q: not (p or q),
         "andny": lambda p, q: (not p) and q, "andyn": lambda p, q: p and not q,
         "orny": lambda p, q: (not p) or q, "oryn": lambda p, q: p or not q}


def test_the_truth_tables():
    for g, name in enumerate(ref.GATE_NAMES):
        for x in (0, 1):
            for y in (0, 1):
                assert ref.TRUTH[g, x, y] == LOGIC[name](bool(x), bool(y)), name


def test_the_gate_ids_are_the_programs():
    from zig_tfhe_tpu_torch.models import gates

    assert gates.GATE_NAMES == ref.GATE_NAMES


def _encrypt(rng, bits, s, width, sd):
    n = s.size
    a = rng.integers(0, 2 ** 63, (bits.size, n), dtype=np.uint64)
    if width == 32:
        a &= np.uint64(0xFFFFFFFF)
    mu = np.where(bits, 1 << (width - 3), -(1 << (width - 3))).astype(np.int64)
    e = np.rint(rng.normal(0, sd, bits.size) * 2.0 ** width).astype(np.int64)
    b = (a * s.astype(np.uint64)).sum(1, dtype=np.uint64) + (mu + e).view(np.uint64)
    ct = np.concatenate([a, b[:, None]], 1)
    if width == 32:
        return (ct & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return ct.view(np.int64)


@pytest.mark.parametrize("width", [32, 64])
def test_judge_reads_the_noise_and_the_wrong_lanes(width):
    rng = np.random.default_rng(3)
    s = rng.integers(0, 2, 700)
    bits = rng.integers(0, 2, 20000).astype(bool)
    ct = _encrypt(rng, bits, s, width, 0.002)
    got = ref.judge(ct, s, width, bits)
    assert got["wrong"] == 0 and got["lanes"] == 20000
    assert got["noise_sd"] == pytest.approx(0.002, rel=0.02)
    flipped = bits.copy()
    flipped[:7] ^= True
    assert ref.judge(ct, s, width, flipped)["wrong"] == 7


def test_judge_wraps_the_distance_on_the_torus():
    s = np.zeros(4, dtype=np.int64)
    # body -3/8 + 2^-20: the wanted +1/8 lies 1/2 - 2^-20 away, not more
    ct = np.array([[0, 0, 0, 0, -(3 << 29) + (1 << 12)]], dtype=np.int32)
    got = ref.judge(ct, s, 32, [True])
    assert got["wrong"] == 1
    assert got["noise_sd"] == pytest.approx(0.5 - 2.0 ** -20)
