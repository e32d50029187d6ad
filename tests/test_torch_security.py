"""The port's security estimator, profiling helpers, package info, and the
import rule of slice 5's modules.

``utils/security.py:estimate_params`` equals the JAX package's on every
parameter set (on the port's own tfhers_2_2, the JAX package's on its
twin); ``time_op`` gives a positive median on the CPU and
``trace`` writes a trace file; the new modules import torch, numpy, the
standard library and the port only.
"""

import ast
import dataclasses
import pathlib
import sys

import pytest
import torch

from zig_tfhe_tpu import params as JP
from zig_tfhe_tpu.utils import security as jsec
import zig_tfhe_tpu_torch
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch.utils import profiling, security as tsec

_ROOT = pathlib.Path(__file__).resolve().parent.parent / "zig_tfhe_tpu_torch"


def _jax_params(name):
    """The JAX package's set of this name; for a set the port alone has
    (tfhers_2_2), its twin, built by the JAX package's own ``_sp`` from the
    port's fields."""
    if name in JP.PARAMS_BY_NAME:
        return JP.PARAMS_BY_NAME[name]
    t = TP.PARAMS_BY_NAME[name]
    return JP._sp(t.name, t.security_bits, t.description, t.n0,
                  t.tlwe_lv0.alpha, t.tlwe_lv1.alpha, t.nbit, t.bgbit, t.L,
                  t.basebit, t.iks_t, N=t.N, torus_bits=t.torus_bits)


@pytest.mark.parametrize("name", sorted(TP.PARAMS_BY_NAME))
def test_estimate_params_equals_jax(name):
    want = jsec.estimate_params(_jax_params(name))
    got = tsec.estimate_params(TP.PARAMS_BY_NAME[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.classical_bits, got.limiting_level) == (
        want.classical_bits, want.limiting_level)


def test_estimators_equal_jax():
    for args in ((630, 32, 2.0 ** -15), (1024, 32, 2.0 ** -25),
                 (2048, 64, 2.0 ** -51.5), (512, 32, 0.0)):
        for f in ("estimate_lwe", "estimate_dual_lwe"):
            assert (dataclasses.asdict(getattr(tsec, f)(*args))
                    == dataclasses.asdict(getattr(jsec, f)(*args))), (f, args)
    assert tsec.log2_delta(400) == jsec.log2_delta(400)


def test_time_op_on_cpu():
    x = torch.arange(1 << 12, dtype=torch.float32)
    t = profiling.time_op(torch.sort, x, iters=3, warmup=1)
    assert isinstance(t, float) and t > 0


def test_trace_writes_a_file(tmp_path):
    with profiling.trace(tmp_path / "tr") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert prof.key_averages() is not None


def test_get_info_on_cpu(capsys):
    info = zig_tfhe_tpu_torch.get_info()
    assert info["name"] == "zig_tfhe_tpu_torch"
    assert info["version"] == zig_tfhe_tpu_torch.__version__
    assert info["default_security"] == TP.DEFAULT_SECURITY.name == "128bit"
    assert info["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    zig_tfhe_tpu_torch.print_info()
    assert "backend: " in capsys.readouterr().out


_NEW_MODULES = ["models/proxy_reenc.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/distributed.py",
                "utils/security.py", "utils/profiling.py", "utils/threefry.py"]


@pytest.mark.parametrize("rel", _NEW_MODULES)
def test_module_imports_torch_numpy_only(rel):
    """Every import, at any depth of the module, is of torch, numpy, the
    standard library or the port itself."""
    tree = ast.parse((_ROOT / rel).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    allowed = {"torch", "numpy", "zig_tfhe_tpu_torch", "__future__"}
    assert names - allowed <= set(sys.stdlib_module_names), names
