"""The benchmark's yardstick: the published HBM rate, the least time of
each hand kernel's function, and the arithmetic of kernel records.

Frozen here so that a change to the program cannot move it.  A kernel's
least time is the bytes of its function's inputs and outputs, moved once,
at the HBM rate: every implementation of the function moves them, however
it computes.  The byte counts are those of the port's measuring script
(``chip_smoke.py``: ``_k1_bound_ms``, ``_k2_bound_ms``, ``_k2s_bound_ms``).
Its operation counts are left out: they count a dense N x N int8 transform,
which is how the kernels compute today, and a kernel that computed the
transform with fewer operations (a four-step or butterfly NTT) would read
above 100% against them.  The least multiplications of a fast NTT (N/2
log2 N a polynomial and prime, at the int32 multiply rate) take less
time than the bytes at every cell's shape, so the bytes are the bound.

The record arithmetic (busy time as the union of kernel spans, the idle
share over the device span) is ``chip_smoke.py``'s ``_print_kernels``.
"""

from __future__ import annotations

# Published peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W
# power limit): HBM bytes per second.
HBM_BPS = 3.35e12


def k1_bound_s(P: int, B: int, N: int) -> float:
    """K1 (inverse NTT, CRT lift, accumulator add) on B accumulators of 2
    polynomials of N coefficients over P primes: the int8 limb planes
    [P, 2B, 2, N], the accumulator in and out (int32) and the two int8
    matrix limbs [P, 2N, N], moved once."""
    rows = 2 * B
    return (P * rows * 2 * N + 2 * rows * N * 4 + 2 * P * N * 2 * N) / HBM_BPS


def k2_bound_s(P: int, N: int, group: int, R: int, n_dl: int, B: int) -> float:
    """K2 (forward NTT of the gadget digits, the pointwise products with the
    step's key, the multi-bit combine) on B lanes: the digits' R * n_dl int8
    limb planes [B, R n_dl, N], the key step int16 [2^g - 1, P, R, 2, N],
    the rotations int32 [g, B], the two int8 forward matrix limbs [P, N, N],
    the rotation rows that the lanes can gather (int16, one of 2N per
    distinct rotation) and the output int8 limb planes [P, B, 2, 2, N],
    moved once."""
    S = (1 << group) - 1
    rot_rows = min(2 * N, group * B)
    return (B * R * n_dl * N + S * P * R * 2 * N * 2 + group * B * 4
            + 2 * P * N * N + rot_rows * P * N * 2 + P * B * 2 * 2 * N) / HBM_BPS


def k2s_bound_s(P: int, Nh: int, RL: int, B: int) -> float:
    """K2s (K2's function at the split-ring shape, N/2 = Nh) on B lanes:
    the hi-plane digits int8 [B, RL, Nh], the key step int16
    [3, P, RL, 4, Nh], the rotations int32 [2, B], the two forward matrix
    limbs [P, Nh, Nh], the rotation rows the lanes can gather (and psi's)
    and the output int8 limb planes [P, B, 2, 2, 2, Nh], moved once.  No
    cell runs it yet; a split-ring configuration added as data reads it."""
    rot_rows = min(4 * Nh, 2 * B) + 1
    return (B * RL * Nh + 3 * P * RL * 4 * Nh * 2 + 2 * B * 4
            + 2 * P * Nh * Nh + rot_rows * P * Nh * 2 + P * B * 8 * Nh) / HBM_BPS


def step_shapes(cfg: dict, lanes: int) -> dict:
    """Each hand kernel's least seconds a call at one blind-rotation step
    of ``lanes`` lanes under configuration ``cfg`` (its file's sizes):
    K1 always; K2 on a 32-bit set, K2s on a split-ring set."""
    P, N = cfg["n_primes"], cfg["N"]
    la, lb = cfg["key"]["decomp_levels"]
    n_dl = -(-cfg["key"]["engine_bgbit"] // 8)
    if cfg["split_ring"]:
        Nh = N // 2
        return {"k1": k1_bound_s(P, 2 * lanes, Nh),
                "k2s": k2s_bound_s(P, Nh, 2 * (la + lb), lanes)}
    return {"k1": k1_bound_s(P, lanes, N),
            "k2": k2_bound_s(P, N, cfg["key"]["group"], la + lb, n_dl, lanes)}


def union_ns(spans) -> int:
    """Nanoseconds covered by at least one (start, end) span."""
    spans = sorted(spans)
    if not spans:
        return 0
    busy, (cur_s, cur_e) = 0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def idle_gaps(spans):
    """The (start, end) gaps between the merged spans, in time order."""
    spans = sorted(spans)
    gaps = []
    if not spans:
        return gaps
    cur_e = spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            gaps.append((cur_e, s))
        cur_e = max(cur_e, e)
    return gaps


def idle_share(spans) -> float:
    """1 - busy / device span (first start to last end), as a fraction."""
    if not spans:
        raise ValueError("no kernel spans")
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    return 1.0 - union_ns(spans) / span
