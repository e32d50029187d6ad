"""The plain reference of a LUT batch: its functions and the judging of
hand-made phases at both torus widths."""

import numpy as np
import pytest

from gpubench.reference import lut as ref


def test_the_functions_on_z16():
    x = np.arange(16)
    want = {"identity": x, "negate": (16 - x) % 16, "square": x * x % 16,
            "double": 2 * x % 16, "message": x & 3, "carry": x >> 2,
            "msb": (x >= 8).astype(int)}
    assert set(ref.FUNCTION_NAMES) == set(want)
    for name, f in ref.FUNCTIONS.items():
        assert np.array_equal(f(x, 16), want[name]), name
        # Python ints too, as the program's generator calls them
        assert [f(int(v), 16) for v in x] == list(want[name]), name


def test_message_and_carry_split_an_odd_width():
    x = np.arange(8)     # b = 3: one message bit, two carry bits
    assert np.array_equal(ref.FUNCTIONS["message"](x, 8), x & 1)
    assert np.array_equal(ref.FUNCTIONS["carry"](x, 8), x >> 1)


def test_expected_picks_each_lanes_function():
    got = ref.expected(("square", "msb"), [[0, 1, 0], [1, 1, 0]],
                       [[3, 9, 5], [7, 8, 15]], 16)
    assert got.tolist() == [[9, 1, 9], [0, 1, 1]]


@pytest.mark.parametrize("m", [0, 1, 12])
def test_a_modulus_that_is_no_power_of_two_is_refused(m):
    with pytest.raises(ValueError, match="power of two"):
        ref.check_modulus(m)


def _trivial(bodies, width):
    """Ciphertexts [rows, 3] with a zero mask: the phase is the body."""
    ct = np.zeros((len(bodies), 3), dtype=np.int32 if width == 32 else np.int64)
    mask = (1 << width) - 1
    for i, v in enumerate(bodies):
        v &= mask
        ct[i, 2] = v - (1 << width) if v >= 1 << (width - 1) else v
    return ct


@pytest.mark.parametrize("width", [32, 64])
def test_judge_decodes_at_the_bin_edges(width):
    m, s = 16, np.array([1, 0])
    step = 1 << (width - 5)         # encode(1) = 2^w / 32
    half = step // 2
    # phase, and the message it decodes to: a half bin rounds up
    cases = [(3 * step, 3), (3 * step + half - 1, 3), (3 * step + half, 4),
             (3 * step - half, 3), (3 * step - half - 1, 2), (-1, 0),
             (-half, 0), (-half - 1, 15), (15 * step + half, 0),
             (16 * step + 2 * step, 2)]
    bodies = [p for p, _ in cases]
    decoded = [d for _, d in cases]
    got = ref.judge(_trivial(bodies, width), s, width, decoded, m)
    assert got["wrong"] == 0 and got["lanes"] == len(cases)
    shifted = [(d + 1) % m for d in decoded]
    assert ref.judge(_trivial(bodies, width), s, width, shifted, m)["wrong"] == len(cases)


@pytest.mark.parametrize("width", [32, 64])
def test_judge_reads_the_signed_distance_from_the_encoding(width):
    m, s = 16, np.array([0, 0])
    step = 1 << (width - 5)
    # encode(5) - 2^-10, encode(0) + 2^-11, encode(15) - 2^-12 of the torus
    bodies = [5 * step - (1 << (width - 10)), 1 << (width - 11),
              15 * step - (1 << (width - 12))]
    err = np.array([-2.0 ** -10, 2.0 ** -11, -2.0 ** -12])
    got = ref.judge(_trivial(bodies, width), s, width, [5, 0, 15], m)
    assert got["wrong"] == 0
    assert got["noise_sd"] == pytest.approx(np.sqrt(np.mean(err ** 2)), rel=1e-12)
    assert got["noise_max"] == pytest.approx(2.0 ** -10, rel=1e-12)
    # against 0, the phase 2^-11 below it: the distance wraps round the torus
    below = ref.judge(_trivial([-(1 << (width - 11))], width), s, width, [0], m)
    assert below["noise_max"] == pytest.approx(2.0 ** -11) and below["wrong"] == 0


@pytest.mark.parametrize("width", [32, 64])
def test_judge_decrypts_under_the_key(width):
    """Random masks under a random key, the body encode(x) + <a, s> + e."""
    rng = np.random.default_rng(5)
    n, rows, m = 700, 5000, 16
    s = rng.integers(0, 2, n)
    x = rng.integers(0, m, rows)
    a = rng.integers(0, 2 ** 63, (rows, n), dtype=np.uint64)
    if width == 32:
        a &= np.uint64(0xFFFFFFFF)
    e = np.rint(rng.normal(0, 0.003, rows) * 2.0 ** width).astype(np.int64)
    mu = x.astype(np.uint64) << np.uint64(width - 5)
    b = (a * s.astype(np.uint64)).sum(1, dtype=np.uint64) + mu + e.view(np.uint64)
    ct = np.concatenate([a, b[:, None]], 1)
    ct = ((ct & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
          if width == 32 else ct.view(np.int64))
    got = ref.judge(ct, s, width, x, m)
    assert got["wrong"] == 0
    assert got["noise_sd"] == pytest.approx(0.003, rel=0.05)
    assert ref.judge(ct, s, width, (x + 1) % m, m)["wrong"] == rows
