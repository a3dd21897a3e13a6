"""ctypes bindings for the native NIfTI batch decoder (csrc/host/nifti_io.cc).

Port of ``multimodal_alzheimer_tpu/data/native_io.py`` with the package's
own copy of the C++ source. ``g++`` builds it at first use into ``_build/``
with the JAX package's Makefile flags (``-O3 -march=native -fPIC
-std=c++17``, ``-lz -lpthread``), so both decoders give the same bits on
one host. The file name carries a hash of the source, the flags and the
target ``-march=native`` resolves to, so an edit, or a copy of the tree on
another CPU, rebuilds. Processes that start together build once: the build
holds a file lock and writes a temporary name that it renames into place.

  * ``nifti_shape(path)`` -> tuple of dims,
  * ``decode(path)`` -> float32 ndarray (Fortran-order spatial axes, like
    ``nifti.load_nifti``),
  * ``decode_batch(paths, shape, num_threads)`` -> (N, *shape) float32,
    decoded concurrently with zero Python in the loop (``ctypes.CDLL``
    releases the GIL for the call).

Falls back to the pure-Python reader when the toolchain is unavailable
(``available()`` reports which path is active; ``build_log()`` holds the
compiler's output of a failed build).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "host" / "nifti_io.cc"
BUILD_DIR = _PACKAGE / "_build"
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lz", "-lpthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_build_log = ""


def library_path() -> Path:
    """The library for this source, these flags and this host's target."""
    target = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                            check=True, capture_output=True, text=True)
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((CXX,) + CXXFLAGS + LDFLAGS).encode())
    digest.update(target.stdout.encode())
    return BUILD_DIR / f"libmmalz_io-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library for it exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libmmalz_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            result = subprocess.run(
                [CXX, *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS],
                capture_output=True, text=True)
            if result.returncode != 0:
                raise RuntimeError(
                    f"{CXX} failed with exit code {result.returncode}:\n"
                    f"{result.stdout}{result.stderr}")
            os.replace(tmp, out)  # atomic: no process loads a partial file
        finally:
            tmp.unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed, _build_log
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            lib.mmalz_nifti_shape.restype = ctypes.c_int
            lib.mmalz_nifti_shape.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.mmalz_nifti_decode.restype = ctypes.c_int64
            lib.mmalz_nifti_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64]
            lib.mmalz_nifti_decode_auto.restype = ctypes.c_int64
            lib.mmalz_nifti_decode_auto.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.mmalz_nifti_decode_batch.restype = ctypes.c_int
            lib.mmalz_nifti_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int]
            _lib = lib
        except Exception as exc:  # no compiler, no zlib, a failed build
            _build_failed = True
            _build_log = f"{type(exc).__name__}: {exc}"
    return _lib


def available() -> bool:
    return _load() is not None


def build_log() -> str:
    """Why the native decoder is unavailable ("" when it is)."""
    _load()
    return _build_log


def nifti_shape(path: str) -> tuple:
    lib = _load()
    if lib is None:
        from multimodal_alzheimer_tpu_torch.data.nifti import load_nifti

        return load_nifti(path).shape
    dims = (ctypes.c_int64 * 8)()
    rc = lib.mmalz_nifti_shape(str(path).encode(), dims)
    if rc != 0:
        raise IOError(f"mmalz_nifti_shape({path}) failed: {rc}")
    ndim = dims[0]
    return tuple(int(dims[1 + i]) for i in range(ndim))


_MAX_VOXELS = 1 << 26  # 64M voxels (256 MiB f32) upper bound per volume
_guess_voxels = 91 * 109 * 91  # adapts to the dataset's volume size


def decode(path: str) -> np.ndarray:
    """Single-volume decode: one read+inflate (native path), fallback to
    the pure-Python reader."""
    global _guess_voxels
    lib = _load()
    if lib is None:
        from multimodal_alzheimer_tpu_torch.data.nifti import load_nifti

        return load_nifti(path)
    capacity = _guess_voxels
    for _ in range(2):
        out = np.empty(capacity, dtype=np.float32)
        dims = (ctypes.c_int64 * 8)()
        got = lib.mmalz_nifti_decode_auto(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            capacity, dims)
        if got == -3 and capacity < _MAX_VOXELS:  # buffer too small
            capacity = _MAX_VOXELS
            continue
        break
    if got < 0:
        raise IOError(f"mmalz_nifti_decode_auto({path}) failed: {got}")
    _guess_voxels = max(_guess_voxels, int(got))
    shape = tuple(int(dims[1 + i]) for i in range(dims[0]))
    if got == capacity:
        return out.reshape(shape, order="F")
    return out[:got].reshape(shape, order="F").copy()


def decode_batch(paths: Sequence[str], shape: tuple,
                 num_threads: int = 8) -> np.ndarray:
    """Concurrent batch decode into one (N, *shape) float32 array.

    All volumes must share ``shape`` (true for the MNI-2mm ADNI grid,
    verified by the reference's Image_Analysis notebook).
    """
    lib = _load()
    if lib is None:
        from multimodal_alzheimer_tpu_torch.data.nifti import load_nifti

        return np.stack([load_nifti(p) for p in paths])
    n = len(paths)
    voxels = int(np.prod(shape))
    out = np.empty((n, voxels), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.mmalz_nifti_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        voxels, num_threads)
    if rc != 0:
        raise IOError(
            f"batch decode failed at file {-rc - 1}: {paths[-rc - 1]}")
    # each row is Fortran-order; reshape accordingly
    return out.reshape((n,) + tuple(reversed(shape))).transpose(
        (0,) + tuple(range(len(shape), 0, -1)))
