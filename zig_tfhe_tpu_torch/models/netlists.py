"""Bristol-fashion netlist generators for scheduler-scale circuits.

Counterpart of zig_tfhe_tpu/models/netlists.py, copied (pure Python; the
port imports nothing of the JAX package), and emitting the same text byte
for byte.  The reference evaluates circuits strictly sequentially in user
code (examples/add_two_numbers.zig:66-70) and ships no netlist tooling; the
serving story runs standard Bristol circuits through the native level
scheduler (models/scheduler.py:parse_bristol -> evaluate).
`bristol_multiplier(64)` emits a Wallace-tree 64x64 -> 128-bit multiplier
(~27k gates) in the same old-Bristol dialect as the classic `mult64`
circuit, and a plain evaluator (`eval_bristol_plain`) is the ground-truth
oracle.

Format (old Bristol fashion, what native/circuit/scheduler.cc:
circuit_parse_bristol reads): header ``n_gates n_wires`` then ``n_in1 n_in2
n_out``; one gate per line ``n_gin n_gout in... out OP``; inputs are wires
0..n_in-1, outputs are the LAST n_out wires.
"""

from __future__ import annotations

from typing import Callable


class _Builder:
    def __init__(self, n_in1: int, n_in2: int):
        self.n_in = n_in1 + n_in2
        self.n_in1, self.n_in2 = n_in1, n_in2
        self.next_wire = self.n_in
        self.lines: list[str] = []

    def gate2(self, op: str, a: int, b: int) -> int:
        w = self.next_wire
        self.next_wire += 1
        self.lines.append(f"2 1 {a} {b} {w} {op}")
        return w

    def gate1(self, op: str, a: int) -> int:
        w = self.next_wire
        self.next_wire += 1
        self.lines.append(f"1 1 {a} {w} {op}")
        return w

    def xor(self, a, b):
        return self.gate2("XOR", a, b)

    def and_(self, a, b):
        return self.gate2("AND", a, b)

    def or_(self, a, b):
        return self.gate2("OR", a, b)

    def full_adder(self, x, y, z):
        """(sum, carry): 5 gates — c = (x AND y) OR (z AND (x XOR y))."""
        s1 = self.xor(x, y)
        s = self.xor(s1, z)
        c1 = self.and_(x, y)
        c2 = self.and_(s1, z)
        return s, self.or_(c1, c2)

    def half_adder(self, x, y):
        return self.xor(x, y), self.and_(x, y)

    def finish(self, outputs: list[int]) -> str:
        # Bristol outputs must be the last n_out wires, in order: re-emit
        # through COPY gates so any wire can be an output.
        for w in outputs:
            self.gate1("EQW", w)
        n_wires = self.next_wire
        n_gates = len(self.lines)
        head = (f"{n_gates} {n_wires}\n"
                f"{self.n_in1} {self.n_in2} {len(outputs)}\n")
        return head + "\n".join(self.lines) + "\n"


def _kogge_stone(b: _Builder, a_bits: list[int], b_bits: list[int]) -> list:
    """W-bit Kogge-Stone adder (no carry-in/out beyond W bits)."""
    W = len(a_bits)
    p = [b.xor(a_bits[i], b_bits[i]) for i in range(W)]
    g = [b.and_(a_bits[i], b_bits[i]) for i in range(W)]
    p_run, g_run = list(p), list(g)
    d = 1
    while d < W:
        np_, ng = list(p_run), list(g_run)
        for i in range(d, W):
            ng[i] = b.or_(g_run[i], b.and_(p_run[i], g_run[i - d]))
            np_[i] = b.and_(p_run[i], p_run[i - d])
        p_run, g_run = np_, ng
        d *= 2
    return [p[0]] + [b.xor(p[i], g_run[i - 1]) for i in range(1, W)]


def bristol_multiplier(w: int = 64) -> str:
    """Wallace-tree w x w -> 2w multiplier in old Bristol fashion.

    Structure of the canonical `mult64`-class circuits: AND partial
    products, 3:2 carry-save reduction to two addends, one final parallel
    adder (Kogge-Stone here, so circuit DEPTH stays ~60 instead of the
    ~512 a ripple chain would force — depth is what the leveled evaluator
    pays per batched bootstrap round).  w=64: 27k gates.
    """
    b = _Builder(w, w)
    a_bits = list(range(w))
    b_bits = list(range(w, 2 * w))
    cols: list[list[int]] = [[] for _ in range(2 * w)]
    for i in range(w):
        for j in range(w):
            cols[i + j].append(b.and_(a_bits[i], b_bits[j]))
    # 3:2 reduction until every column has <= 2 wires
    while any(len(c) > 2 for c in cols):
        nxt: list[list[int]] = [[] for _ in range(2 * w)]
        for k, c in enumerate(cols):
            while len(c) >= 3:
                s, cy = b.full_adder(c.pop(), c.pop(), c.pop())
                nxt[k].append(s)
                if k + 1 < 2 * w:
                    nxt[k + 1].append(cy)
            if len(c) == 2 and nxt[k]:
                # keep columns shrinking: half-adder the leftover pair
                s, cy = b.half_adder(c.pop(), c.pop())
                nxt[k].append(s)
                if k + 1 < 2 * w:
                    nxt[k + 1].append(cy)
            nxt[k].extend(c)
        cols = nxt
    # two addends (pad empty columns with a constant-0 = XOR(a0, a0))
    zero = None
    x_bits, y_bits = [], []
    for k in range(2 * w):
        c = cols[k]
        if not c or len(c) < 2:
            if zero is None:
                zero = b.xor(a_bits[0], a_bits[0])
        x_bits.append(c[0] if len(c) >= 1 else zero)
        y_bits.append(c[1] if len(c) >= 2 else zero)
    return b.finish(_kogge_stone(b, x_bits, y_bits))


_PLAIN_OPS: dict[str, Callable] = {
    "AND": lambda x, y: x & y, "NAND": lambda x, y: 1 - (x & y),
    "OR": lambda x, y: x | y, "NOR": lambda x, y: 1 - (x | y),
    "XOR": lambda x, y: x ^ y, "XNOR": lambda x, y: 1 - (x ^ y),
    "ANDNY": lambda x, y: (1 - x) & y, "ANDYN": lambda x, y: x & (1 - y),
    "ORNY": lambda x, y: (1 - x) | y, "ORYN": lambda x, y: x | (1 - y),
}


def eval_bristol_plain(text: str, in_bits: list[int]) -> list[int]:
    """Plain-boolean oracle for a Bristol netlist (test ground truth)."""
    lines = text.strip().split("\n")
    n_gates, n_wires = map(int, lines[0].split())
    n_in1, n_in2, n_out = map(int, lines[1].split())
    assert len(in_bits) == n_in1 + n_in2, (len(in_bits), n_in1 + n_in2)
    wires = [0] * n_wires
    wires[: len(in_bits)] = [int(v) & 1 for v in in_bits]
    for ln in lines[2: 2 + n_gates]:
        parts = ln.split()
        n_gin, n_gout = int(parts[0]), int(parts[1])
        ins = [int(v) for v in parts[2: 2 + n_gin]]
        out = int(parts[2 + n_gin])
        op = parts[-1]
        if op in ("INV", "NOT"):
            wires[out] = 1 - wires[ins[0]]
        elif op in ("EQW", "COPY"):
            wires[out] = wires[ins[0]]
        elif op == "MUX":
            wires[out] = wires[ins[1]] if wires[ins[0]] else wires[ins[2]]
        else:
            wires[out] = _PLAIN_OPS[op](wires[ins[0]], wires[ins[1]])
    return wires[n_wires - n_out:]
