"""Decoded-volume cache: decode each NIfTI once, then read it mapped.

Port of ``multimodal_alzheimer_tpu/data/cache.py``. The reference decodes
every volume again in every epoch (reference: pkg/utils/dataloader.py:206,
228). This cache decodes each volume once into a raw ``.npy`` and serves
later reads with ``np.load(mmap_mode='r')``, from the OS page cache.

``dtype`` optionally narrows the stored entries (float16 halves the bytes
of a volume; ADNI MRI intensities of 0-3000 and PET of about N(0.5, 0.5)
fit it with about 5e-4 relative error). Narrow volumes stay narrow through
collate and the host-to-device copy; the device preprocess
(``data/preprocess.py``) casts them to float32 before any arithmetic.

Entries are keyed by the file's path, size, mtime and the dtype, so a
changed file or another dtype never reads a stale entry. A miss decodes
through the native decoder (``data/native_io.py``), as in JAX.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional

import numpy as np

from multimodal_alzheimer_tpu_torch.data import native_io


class VolumeCache:
    def __init__(self, cache_dir: str | Path,
                 dtype: Optional[str | np.dtype] = None):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.dtype = np.dtype(dtype) if dtype is not None else None

    def _key(self, path: str) -> Path:
        st = os.stat(path)
        dt = self.dtype.name if self.dtype is not None else "native"
        token = f"{os.path.abspath(path)}|{st.st_size}|{int(st.st_mtime)}|{dt}"
        digest = hashlib.sha1(token.encode()).hexdigest()[:24]
        return self.cache_dir / f"{digest}.npy"

    def get(self, path: str) -> np.ndarray:
        """The decoded volume (in ``self.dtype`` if set), mapped on a hit."""
        entry = self._key(path)
        if entry.exists():
            return np.load(entry, mmap_mode="r")
        volume = np.ascontiguousarray(native_io.decode(path))
        if self.dtype is not None:
            volume = volume.astype(self.dtype)
        tmp = entry.with_suffix(f".{os.getpid()}.tmp.npy")
        np.save(tmp, volume)
        os.replace(tmp, entry)  # atomic: no reader sees a half-written file
        return volume
