"""Minimal NIfTI-1 volume I/O with numpy and gzip (no nibabel).

Port of ``multimodal_alzheimer_tpu/data/nifti.py``. The reference loads
scans with ``nib.load(path).get_fdata()`` (reference:
pkg/utils/dataloader.py:206-207, 228-229), which returns the raw array with
the file's ``scl_slope``/``scl_inter`` applied. Same contract here for
single-file ``.nii`` and ``.nii.gz`` volumes of either byte order: header
parse, Fortran-order data, optional scaling, and the same errors as the JAX
package's reader. It is the plain reader: the dataset and the volume
cache decode through the native decoder (``data/native_io.py``), which
falls back to this reader where it cannot be built.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


def _read_bytes(path: str | Path) -> bytes:
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def load_nifti(path: str | Path, dtype=np.float32,
               apply_scaling: bool = True) -> np.ndarray:
    """Load a NIfTI-1 volume; the equivalent of ``nib.load(p).get_fdata()``.

    Returns the spatial array in the file's (Fortran) axis order, cast to
    ``dtype`` (float32 by default, as the reference casts before the model).
    """
    raw = _read_bytes(path)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")

    if struct.unpack_from("<i", raw, 0)[0] == _HDR_SIZE:
        end = "<"
    elif struct.unpack_from(">i", raw, 0)[0] == _HDR_SIZE:
        end = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file")

    ndim = struct.unpack_from(end + "h", raw, 40)[0]
    dims = struct.unpack_from(end + "7h", raw, 42)[:ndim]
    datatype = struct.unpack_from(end + "h", raw, 70)[0]
    vox_offset = int(struct.unpack_from(end + "f", raw, 108)[0])
    scl_slope = struct.unpack_from(end + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(end + "f", raw, 116)[0]
    magic = raw[344:348]

    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    if magic[:3] == b"ni1":
        raise ValueError(f"{path}: two-file NIfTI (.hdr/.img) not supported")

    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(end)
    count = int(np.prod(dims))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=vox_offset)
    vol = data.reshape(dims, order="F").astype(dtype)

    if apply_scaling and scl_slope != 0.0 and not np.isnan(scl_slope):
        if scl_slope != 1.0 or (scl_inter != 0.0 and not np.isnan(scl_inter)):
            inter = 0.0 if np.isnan(scl_inter) else scl_inter
            vol = vol * dtype(scl_slope) + dtype(inter)
    return vol


def save_nifti(path: str | Path, volume: np.ndarray) -> None:
    """Write a minimal single-file little-endian NIfTI-1 (.nii or .nii.gz)
    volume, byte for byte as the JAX package writes it."""
    volume = np.asarray(volume)
    if volume.dtype not in _DTYPE_CODES:
        volume = volume.astype(np.float32)
    header = bytearray(352)  # 348-byte header + 4-byte extension flag
    struct.pack_into("<i", header, 0, _HDR_SIZE)
    dims = (volume.ndim,) + volume.shape + (1,) * (7 - volume.ndim)
    struct.pack_into("<8h", header, 40, *dims)
    struct.pack_into("<h", header, 70, _DTYPE_CODES[volume.dtype])
    struct.pack_into("<h", header, 72, volume.dtype.itemsize * 8)
    # pixdim: qfac + unit voxel sizes
    struct.pack_into("<8f", header, 76, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)    # scl_slope
    struct.pack_into("<f", header, 116, 0.0)    # scl_inter
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + volume.tobytes(order="F")
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
