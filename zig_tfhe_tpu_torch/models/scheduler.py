"""Circuit scheduler bindings + level-by-level evaluator.

Counterpart of zig_tfhe_tpu/models/scheduler.py.  The native C++ scheduler
(native/circuit/scheduler.cc, backend-neutral and shared with the JAX
package) levels a boolean circuit DAG and allocates wire slots; this module
compiles it with g++ into zig_tfhe_tpu_torch/_build/, binds it through
ctypes, and evaluates the resulting plan over a ciphertext arena
[n_slots + 1, B, n0 + 1]: each level's two-input gates run as one
heterogeneous ``gates.apply_gates`` bootstrap, its MUX lanes as one
``gates.mux``, and NOT/COPY/CONST as tensor ops.

The plan is the JAX package's, array for array: the same native code with
the same super-level cap (2048 rotation lanes, its default).  The JAX
evaluator also pads each level's groups to power-of-two widths, splits
wide levels into knee-sized chunks, and runs equal-width levels as one
``lax.scan``; those are compile-cache and dispatch-floor workarounds for
the TPU.  The gates of a level are independent (no gate reads a same-level
output, and slots are freed only at level boundaries), so every partition
of a level gives the same bits; this evaluator runs each group whole and
skips empty ones.

No reference analog: zig-tfhe evaluates circuits gate by gate in user code
(examples/add_two_numbers.zig:66-70).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from zig_tfhe_tpu_torch.key import CloudKey
from zig_tfhe_tpu_torch.models import gates as G
from zig_tfhe_tpu_torch.utils.torus import carrier_dtype

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "circuit" / "scheduler.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

# op codes >= 100 (must match scheduler.cc enum Op)
OP_NOT, OP_COPY, OP_CONST0, OP_CONST1, OP_MUX = 100, 101, 102, 103, 104

# Rotation lanes per super-level: the JAX package's default cap (its
# ZTFHE_SUPER_LEVEL), so that both packages schedule the same plan.
SUPER_LEVEL_CAP = 2048


def library_path() -> Path:
    """The scheduler's shared library, named by the hash of the source and
    the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"circuit_scheduler_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile into a temporary file, then rename: concurrent builders
    (test workers, say) each write their own file, and a reader never sees
    a half-written library."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("building the native circuit scheduler needs a "
                           f"C++17 compiler (g++) for {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building the native circuit scheduler "
                               f"failed:\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def _load() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    i32p = ctypes.POINTER(i32)
    sigs = {
        "tfhe_circuit_new": ([], vp),
        "tfhe_circuit_free": ([vp], None),
        "tfhe_circuit_parse_bristol": ([ctypes.c_char_p], vp),
        "tfhe_circuit_error": ([vp], ctypes.c_char_p),
        "tfhe_circuit_add_wire": ([vp], i32),
        "tfhe_circuit_add_gate": ([vp, i32, i32, i32, i32], i32),
        "tfhe_circuit_mark_input": ([vp, i32], None),
        "tfhe_circuit_mark_output": ([vp, i32], None),
        "tfhe_schedule_capped": ([vp, i32], vp),
        "tfhe_plan_free": ([vp], None),
        "tfhe_plan_error": ([vp], ctypes.c_char_p),
        "tfhe_plan_n_levels": ([vp], i32),
        "tfhe_plan_n_gates": ([vp], i32),
        "tfhe_plan_n_slots": ([vp], i32),
        "tfhe_plan_n_inputs": ([vp], i32),
        "tfhe_plan_n_outputs": ([vp], i32),
        "tfhe_plan_level_offsets": ([vp], i32p),
        "tfhe_plan_gates": ([vp, i32p], None),
        "tfhe_plan_input_slots": ([vp, i32p], None),
        "tfhe_plan_output_slots": ([vp, i32p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


@dataclass
class Plan:
    """A leveled, slot-allocated evaluation plan."""

    levels: list          # int32 np arrays [k, 5]: op, s0, s1, s2, sout
    n_slots: int
    input_slots: np.ndarray
    output_slots: np.ndarray

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def n_gates(self) -> int:
        return sum(len(l) for l in self.levels)


class Circuit:
    """Python-side circuit builder over the native graph."""

    def __init__(self):
        self._lib = _load()
        self._c = self._lib.tfhe_circuit_new()

    def __del__(self):
        if getattr(self, "_c", None):
            self._lib.tfhe_circuit_free(self._c)
            self._c = None

    def input(self) -> int:
        w = self._lib.tfhe_circuit_add_wire(self._c)
        self._lib.tfhe_circuit_mark_input(self._c, w)
        return w

    def gate(self, name: str, a: int, b: int) -> int:
        return self._lib.tfhe_circuit_add_gate(self._c, G.GATE_IDS[name],
                                               a, b, -1)

    def not_(self, a: int) -> int:
        return self._lib.tfhe_circuit_add_gate(self._c, OP_NOT, a, -1, -1)

    def copy(self, a: int) -> int:
        return self._lib.tfhe_circuit_add_gate(self._c, OP_COPY, a, -1, -1)

    def const(self, value: bool) -> int:
        return self._lib.tfhe_circuit_add_gate(
            self._c, OP_CONST1 if value else OP_CONST0, -1, -1, -1)

    def mux(self, sel: int, t: int, f: int) -> int:
        """(sel ? t : f)."""
        return self._lib.tfhe_circuit_add_gate(self._c, OP_MUX, sel, t, f)

    def output(self, w: int) -> None:
        self._lib.tfhe_circuit_mark_output(self._c, w)

    def schedule(self) -> Plan:
        return _schedule_circuit_handle(self._lib, self._c)


def _plan_from_native(lib, p) -> Plan:
    """A complete Plan from a native plan handle (raises on its error)."""
    err = lib.tfhe_plan_error(p).decode()
    if err:
        raise ValueError(f"schedule error: {err}")
    n_levels = lib.tfhe_plan_n_levels(p)
    offs = np.ctypeslib.as_array(lib.tfhe_plan_level_offsets(p),
                                 shape=(n_levels + 1,)).copy()

    def fetch(fn, shape):
        out = np.zeros(shape, np.int32)
        if out.size:
            fn(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    gates = fetch(lib.tfhe_plan_gates, (lib.tfhe_plan_n_gates(p), 5))
    return Plan(levels=[gates[offs[i]:offs[i + 1]] for i in range(n_levels)],
                n_slots=lib.tfhe_plan_n_slots(p),
                input_slots=fetch(lib.tfhe_plan_input_slots,
                                  lib.tfhe_plan_n_inputs(p)),
                output_slots=fetch(lib.tfhe_plan_output_slots,
                                   lib.tfhe_plan_n_outputs(p)))


def _schedule_circuit_handle(lib, c) -> Plan:
    p = lib.tfhe_schedule_capped(c, SUPER_LEVEL_CAP)
    try:
        plan = _plan_from_native(lib, p)
    finally:
        lib.tfhe_plan_free(p)
    _check_no_unresolved_slots(plan)
    return plan


def parse_bristol(text: str) -> Plan:
    """Parse + schedule a Bristol-fashion circuit."""
    lib = _load()
    c = lib.tfhe_circuit_parse_bristol(text.encode())
    try:
        err = lib.tfhe_circuit_error(c).decode()
        if err:
            raise ValueError(f"parse error: {err}")
        return _schedule_circuit_handle(lib, c)
    finally:
        lib.tfhe_circuit_free(c)


def schedule(circuit: Circuit) -> Plan:
    """Schedule a built circuit (leveling + slot allocation)."""
    return circuit.schedule()


def _check_no_unresolved_slots(plan: Plan) -> None:
    """The native side errors on unproduced wires, so a -1 slot in a
    required operand position should be impossible; check anyway: a -1
    index would wrap to the last arena row and silently read a wrong
    ciphertext.  (Unused positions are legitimately -1: s1/s2 of NOT and
    COPY, s2 of two-input gates, every input of CONST.)"""
    if (plan.output_slots < 0).any():
        raise ValueError("plan has outputs with unresolved (-1) arena slots")
    for lvl in plan.levels:
        op = lvl[:, 0]
        need_s0 = (op < 100) | (op == OP_NOT) | (op == OP_COPY) | (op == OP_MUX)
        need_s1 = (op < 100) | (op == OP_MUX)
        need_s2 = op == OP_MUX
        bad = ((need_s0 & (lvl[:, 1] < 0)) | (need_s1 & (lvl[:, 2] < 0))
               | (need_s2 & (lvl[:, 3] < 0)) | (lvl[:, 4] < 0))
        if bad.any():
            raise ValueError("plan contains unresolved (-1) arena slots")


def _run_level(arena: torch.Tensor, lvl: np.ndarray, ck: CloudKey) -> None:
    """One level's arena update, in the JAX package's group order: gates,
    MUXes, NOT, COPY, CONST0, CONST1.  Groups with no lanes are skipped
    (a level may hold no bootstrapped gate)."""
    B, width = arena.shape[1], arena.shape[2]
    sout = lvl[:, 4]
    # index writes with a repeated index are nondeterministic on CUDA; a
    # plan gives each output of a level its own slot
    if len(np.unique(sout)) != len(sout):
        raise ValueError("a plan level writes one arena slot twice")
    op = lvl[:, 0]

    def idx(col):
        return torch.from_numpy(col.astype(np.int64)).to(arena.device)

    def rows(col):                       # [k, B, n0+1] -> [k*B, n0+1]
        return arena[idx(col)].reshape(-1, width)

    two = lvl[op < 100]
    if len(two):
        out = G.apply_gates(idx(np.repeat(two[:, 0], B)), rows(two[:, 1]),
                            rows(two[:, 2]), ck)
        arena[idx(two[:, 4])] = out.reshape(-1, B, width)
    mux = lvl[op == OP_MUX]
    if len(mux):
        out = G.mux(rows(mux[:, 1]), rows(mux[:, 2]), rows(mux[:, 3]), ck)
        arena[idx(mux[:, 4])] = out.reshape(-1, B, width)
    for code, fn in ((OP_NOT, G.not_), (OP_COPY, G.copy)):
        un = lvl[op == code]
        if len(un):
            arena[idx(un[:, 4])] = fn(arena[idx(un[:, 1])])
    for code, value in ((OP_CONST0, False), (OP_CONST1, True)):
        consts = lvl[op == code]
        if len(consts):
            arena[idx(consts[:, 4])] = G.constant(
                value, ck.params, batch=(len(consts), B), device=arena.device)


def evaluate(plan: Plan, input_cts: torch.Tensor,
             ck: CloudKey) -> torch.Tensor:
    """Evaluate a scheduled circuit over encrypted inputs.

    input_cts: carrier [n_inputs, n0+1] (int32, int64 on the 64-bit
    torus) in plan input order, or [n_inputs, B, n0+1] to run the same plan
    over B client input sets (the serving mode: each level's gates of all
    clients share one bootstrap).  Returns carrier [n_outputs, n0+1] (or
    [n_outputs, B, n0+1]) on the inputs' device.
    """
    n0 = ck.params.n0
    dtype = carrier_dtype(ck.params.torus_bits)
    batched = input_cts.dim() == 3
    if not batched:
        input_cts = input_cts[:, None]
    if (input_cts.dim() != 3 or input_cts.dtype != dtype
            or input_cts.shape[0] != len(plan.input_slots)
            or input_cts.shape[2] != n0 + 1):
        raise ValueError(
            f"inputs must be {dtype} [{len(plan.input_slots)}, (B,) "
            f"{n0 + 1}], not {input_cts.dtype} {tuple(input_cts.shape)}")
    dev = input_cts.device
    # the last row is the JAX package's trash row (padded lanes write it);
    # nothing writes it here, and the arena keeps the same shape
    arena = torch.zeros((plan.n_slots + 1, input_cts.shape[1], n0 + 1),
                        dtype=dtype, device=dev)
    arena[torch.from_numpy(plan.input_slots.astype(np.int64)).to(dev)] = input_cts
    for lvl in plan.levels:
        _run_level(arena, lvl, ck)
    outs = arena[torch.from_numpy(plan.output_slots.astype(np.int64)).to(dev)]
    return outs if batched else outs[:, 0]
