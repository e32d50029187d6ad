"""The build cache key of the port's CUDA kernels (ops/cuda/_build.py).

A kernel's library is cached under a name that hashes everything its code
can change with: the source, every header of its directory (a source may
include any of them), the compiler flags and a measuring script's extra
defines.  Runs on the CPU: nothing is compiled.
"""

import shutil

import pytest

from zig_tfhe_tpu_torch.ops.cuda import _build


@pytest.fixture
def csrc(tmp_path):
    """A private copy of the kernel sources."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


@pytest.mark.parametrize("source", ["ntt_inverse.cu", "ntt_step.cu", "extprod.cu"])
def test_library_path_follows_source_and_headers(csrc, source):
    src = csrc / source
    header = csrc / "hopper_prims.cuh"
    assert header in _build.headers(src)
    path = _build.library_path(src)
    assert path.parent == _build.BUILD_DIR and path.name.startswith(src.stem + "_")
    assert _build.library_path(src) == path                  # stable
    header.write_bytes(header.read_bytes() + b"\n// changed\n")
    with_header = _build.library_path(src)
    assert with_header != path                               # a header's bytes
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert _build.library_path(src) not in (path, with_header)   # the source's


def test_library_path_follows_new_headers_flags_and_defines(csrc, monkeypatch):
    src = csrc / "ntt_step.cu"
    path = _build.library_path(src)
    assert _build.library_path(src, ("-DZTFHE_PROBE_NO_PRODUCT",)) != path
    (csrc / "extra.cuh").write_text("// a header added later\n")
    assert _build.library_path(src) != path
    (csrc / "extra.cuh").unlink()
    assert _build.library_path(src) == path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path(src) != path
