"""Build the port's CUDA sources at first use and bind them with ctypes.

``nvcc`` compiles every source in ``csrc/`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds).
The file name carries a hash of the sources and flags, so an edit rebuilds;
the build directory ``_build/`` beside the sources is not committed. No
``--use_fast_math``: it turns ``/`` into an approximate division and the
kernels must match their plain versions exactly.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCES = (_PACKAGE / "csrc" / "minmax_norm.cu",
           _PACKAGE / "csrc" / "batch_norm.cu",
           _PACKAGE / "csrc" / "zscore_norm.cu",
           _PACKAGE / "csrc" / "maxpool_bwd.cu")
BUILD_DIR = _PACKAGE / "_build"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


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
    digest.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libport_kernels-{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    """nvcc's output of the last build, ``-Xptxas -v`` register counts
    included."""
    return library_path().with_suffix(".log")


def _run_all(commands: list) -> list:
    """Run the commands in parallel; return their (code, stdout + stderr)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    return [(proc.returncode, out)
            for proc, out in ((p, p.communicate()[0]) for p in procs)]


def build() -> Path:
    """Compile the sources unless a library for them exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    try:
        results = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o",
                             str(obj)] for src, obj in zip(SOURCES, objects)])
        results += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objects)]]
                            if all(code == 0 for code, _ in results) else [])
        log = "".join(text for _, text in results)
        failed = [code for code, _ in results if code != 0]
        if failed:
            raise RuntimeError(
                f"nvcc failed with exit code {failed[0]}:\n{log}")
        build_log_path().write_text(log)
        os.replace(tmp, out)  # atomic: no process loads a half-written file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
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
    lib.bn_stats.argtypes = [ptr, i64, i64, i64, ptr, i64, ptr]
    lib.bn_stats.restype = ctypes.c_int
    lib.bn_apply.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                             i64, ptr]
    lib.bn_apply.restype = ctypes.c_int
    lib.bn_grad_sum.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr, i64,
                                ptr]
    lib.bn_grad_sum.restype = ctypes.c_int
    lib.bn_dx.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                          i64, ptr]
    lib.bn_dx.restype = ctypes.c_int
    lib.zscore_workspace_bytes.argtypes = [i64, i64]
    lib.zscore_workspace_bytes.restype = i64
    lib.zscore_norm.argtypes = [ptr, ptr, ptr, i64, i64, ptr, i64, ptr]
    lib.zscore_norm.restype = ctypes.c_int
    lib.maxpool_bwd_slab.argtypes = [i64, i64, i64, i64]
    lib.maxpool_bwd_slab.restype = i64
    lib.maxpool_bwd.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64,
                                i64, ptr]
    lib.maxpool_bwd.restype = ctypes.c_int
    return lib


def on_cuda(x) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise. A
    wrapper launches its kernel for the first and runs its plain version
    for the second."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().minmax_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
