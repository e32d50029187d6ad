"""Build and load the port's hand-written CUDA kernels.

Every source in zig_tfhe_tpu_torch/csrc/ is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
cached in zig_tfhe_tpu_torch/_build/ (git-ignored) under the hash of the
source, of every header in csrc/ (a source may include any of them) and of
the flags, and loaded with ``ctypes``.  ``build`` starts one
``nvcc`` per source, all at once, and waits for them together.  Each
library exports ``ztfhe_cuda_error_string`` beside its launch functions,
which return ``cudaGetLastError()`` after the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           f"build the kernels in {CSRC}")
    return nvcc


def headers(source: Path) -> list:
    """The headers ``source`` can include: all of its directory's."""
    return sorted(h for pat in ("*.cuh", "*.h") for h in source.parent.glob(pat))


def library_path(source: Path, defines: tuple = ()) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in headers(source):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(*sources: Path, defines: tuple = ()) -> dict:
    """Compile each source's shared library (always; atomic replace), one
    ``nvcc`` process per source, all running at once.  Returns each
    source's nvcc report (ptxas: every kernel's registers, shared memory
    and spills).  ``defines`` are extra ``-D...`` flags (a measuring
    script's stage switches); they are part of the library's name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, *defines, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, proc))
    failed, logs = [], {}
    for src, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(src, defines))
        else:
            failed.append(f"nvcc failed building {src}:\n{out}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The source's library, built first if this source has none yet."""
    so = library_path(source)
    if not so.exists():
        build(source)
    lib = ctypes.CDLL(str(so))
    lib.ztfhe_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ztfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.ztfhe_cuda_error_string(err).decode())
