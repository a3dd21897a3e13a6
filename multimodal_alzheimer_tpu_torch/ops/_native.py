"""Build the port's CUDA sources at first use and bind them with ctypes.

``nvcc`` compiles ``csrc/minmax_norm.cu`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The file name carries a hash of the sources and flags, so an edit
rebuilds; the build directory ``_build/`` beside the sources is not
committed. No ``--use_fast_math``: it turns ``/`` into an approximate
division and the kernels must match their plain versions exactly.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCES = (_PACKAGE / "csrc" / "minmax_norm.cu",)
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libminmax_norm-{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    """nvcc's output of the last build, ``-Xptxas -v`` register counts
    included."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile the sources unless a library for them exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    build_log_path().write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: no process loads a half-written file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.minmax_select_workspace_words.argtypes = [i64, i64, i64]
    lib.minmax_select_workspace_words.restype = i64
    lib.minmax_select.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr, ptr,
                                  i64, ptr]
    lib.minmax_select.restype = ctypes.c_int
    lib.minmax_apply.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.minmax_apply.restype = ctypes.c_int
    lib.minmax_error_string.argtypes = [ctypes.c_int]
    lib.minmax_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().minmax_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
