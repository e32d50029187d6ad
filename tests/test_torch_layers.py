"""The port's ops modules stack in one direction.

Each module under zig_tfhe_tpu_torch/ops/ imports, at module level or
inside a function, only package modules of the rows below its own in
``STACK`` (top first; README.md's port section draws it), and no other
module's ``_private`` name.  ``UPWARD`` lists the imports that go the
other way, each with its reason; a function-level import of a package
module must be one of them.  The blind rotation's step span opens at one
site for the NTT rings and one for the Toeplitz engine.  Read from each
module's AST; the file imports neither torch nor jax.
"""

import ast
from pathlib import Path

import pytest

PKG = "zig_tfhe_tpu_torch"
ROOT = Path(__file__).resolve().parents[1] / PKG

# top first: a module imports only package modules of the rows after its own
STACK = (
    ("ops.blind_rotate",),          # entry: the engine choice, the Toeplitz scan
    ("ops.split_ring",),            # the split ring: set-up, keygen, plain chain
    ("ops.blind_rotate_ntt",),      # the direct ring, the key's form, the loop
    ("ops.cuda.split_step", "ops.cuda.extprod"),     # kernels and their
    ("ops.cuda.ntt_step",),                          # plain versions
    ("ops.cuda.ntt_inverse",),
    ("ops.cuda._build",),
    ("ops.packing_keyswitch",),     # the key switches, beside the rotation
    ("ops.keyswitch",),
    ("ops.decomposition", "trgsw", "trlwe"),   # digit formats, encryptions,
    ("ops.ntt",),                              # plan, arithmetic
    ("ops.poly",),
    ("params", "utils.profiling", "utils.torus"),
)
RANK = {m: len(STACK) - i for i, row in enumerate(STACK) for m in row}

UPWARD = {
    ("ops.cuda.split_step", "ops.split_ring"):
        "K2s's plain version is split_ring's prime-batched chain, which stays "
        "beside blind_rotate_split (gpubench/tests/"
        "test_gpubench_reference_t64.py calls it there)",
}

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "ops").rglob("*.py") if p.name != "__init__.py")


def _is_module(name: str) -> bool:
    path = ROOT.joinpath(*name.split("."))
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def _imports(module: str):
    """(target module, names taken from it, at function level) for each
    package import of ``module``, and the aliases bound to modules."""
    tree = ast.parse((ROOT.joinpath(*module.split(".")).with_suffix(".py"))
                     .read_text())
    nested = {id(n) for f in ast.walk(tree)
              if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
              for n in ast.walk(f) if n is not f}
    found, aliases = [], set()
    for node in ast.walk(tree):
        inner = id(node) in nested
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(PKG + "."):
                    found.append((a.name[len(PKG) + 1:], (), inner))
                    aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.module == PKG or node.module.startswith(PKG + ".")):
            base = node.module[len(PKG) + 1:]
            for a in node.names:
                sub = f"{base}.{a.name}" if base else a.name
                if _is_module(sub):
                    found.append((sub, (), inner))
                    aliases.add(a.asname or a.name)
                else:
                    found.append((base, (a.name,), inner))
    private = sorted(
        f"{n.value.id}.{n.attr}" for n in ast.walk(tree)
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
        and n.value.id in aliases and n.attr.startswith("_")
        and not n.attr.startswith("__"))
    return found, private


def test_every_ops_module_has_a_row():
    assert set(MODULES) <= set(RANK), set(MODULES) - set(RANK)


@pytest.mark.parametrize("module", MODULES)
def test_imports_point_down(module):
    found, private = _imports(module)
    for target, names, inner in found:
        edge = (module, target)
        assert target in RANK, f"{module} imports {target}, which has no row"
        assert RANK[target] < RANK[module] or edge in UPWARD, (
            f"{module} imports {target}, which is not below it")
        assert not inner or edge in UPWARD, (
            f"{module} imports {target} inside a function")
        assert not [n for n in names if n.startswith("_")], (
            f"{module} imports {names} from {target}")
    assert not private, f"{module} reads {private}"


def test_every_upward_import_is_made():
    made = {(m, t) for m in MODULES for t, _, _ in _imports(m)[0]}
    assert set(UPWARD) <= made


def test_step_span_opens_at_two_sites():
    """ops/blind_rotate_ntt.py's loop (both NTT rings) and the Toeplitz
    scan of ops/blind_rotate.py."""
    sites = [f"{p.relative_to(ROOT)}"
             for p in sorted(ROOT.rglob("*.py"))
             for n in ast.walk(ast.parse(p.read_text()))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "span" and n.args
             and isinstance(n.args[0], ast.Constant)
             and n.args[0].value == "blind_rotate.steps"]
    assert sites == ["ops/blind_rotate.py", "ops/blind_rotate_ntt.py"]
