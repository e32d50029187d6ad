"""What a run and the reference may load, by whole top-level names."""

import subprocess
import sys

import pytest
from conftest import ROOT

from gpubench import importcheck

HARNESS = sorted(p for p in (ROOT / "gpubench").rglob("*.py")
                 if "tests" not in p.parts)
REFERENCE = sorted((ROOT / "gpubench" / "reference").rglob("*.py"))


@pytest.mark.parametrize("module, refused", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("zig_tfhe_tpu", True), ("zig_tfhe_tpu.ops.ntt", True),
    ("zig_tfhe_tpu_torch", False), ("zig_tfhe_tpu_torch.ops.ntt", False),
    ("jaxtyping", False), ("zig_tfhe_tpu2", False)])
def test_names_are_compared_whole(module, refused):
    assert bool(importcheck.refused([module])) == refused


def test_the_port_is_refused_in_the_reference_only():
    assert importcheck.refused(["zig_tfhe_tpu_torch.key"],
                               importcheck.REFUSED_IN_REFERENCE)
    assert not importcheck.refused(["zig_tfhe_tpu_torch.key"])


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_harness_source_imports_jax_the_smoke_script_or_tools(path):
    found = importcheck.imports_of(path)
    assert not importcheck.refused(found)
    assert not importcheck.refused(found, {"chip_smoke", "tools", "bench"})


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    found = importcheck.imports_of(path)
    assert not importcheck.refused(found, importcheck.REFUSED_IN_REFERENCE)


def test_loading_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import gpubench.reference.gates, gpubench.reference.lut;"
            "from gpubench import importcheck as c;"
            "print(c.refused(sys.modules, c.REFUSED_IN_REFERENCE))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_a_run_of_the_window_loads_no_jax(tiny_root):
    code = ("import sys; sys.path.insert(0, %r); from pathlib import Path;"
            "from gpubench import manifest, run, importcheck as c;"
            "r = run.run_cell(manifest.Bench(Path(%r)), 'tiny.one_lane', 7, 0.2,"
            " False, 'cpu'); print(r['correct'], c.refused(sys.modules))"
            % (str(ROOT), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.split("\n")[-2] == "True []"
