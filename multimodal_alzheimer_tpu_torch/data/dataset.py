"""MultiModalDataset: manifest CSV -> paired multimodal samples, no pandas.

Port of ``multimodal_alzheimer_tpu/data/dataset.py:40-380`` (reference:
pkg/utils/dataloader.py:21-344) with the same constructor and semantics.
``__getitem__`` returns RAW volumes (and the brain mask under
``per_scan_norm``); normalisation runs on the device inside the step
(``get_device_preprocess()``), so the host only decodes files.
``host_normalized_item`` reproduces the reference's host-side output.

The manifest is read with the ``csv`` module into a list of row dicts,
``rows``, in file order: an empty cell (or another of ``pd.read_csv``'s
missing-value markers) is ``None``, as the JAX package's
``replace({np.nan: None})`` leaves it, and a column whose every non-empty
cell is a number holds Python ints or floats, as ``pd.read_csv`` infers
int64 or float64 (a column of ints with a gap becomes floats).
"""

from __future__ import annotations

import csv
import hashlib
import os
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.cache import VolumeCache
from multimodal_alzheimer_tpu_torch.data.nifti import load_nifti
from multimodal_alzheimer_tpu_torch.data.pairing import expand_pairings
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.tabular import tabular_vector
from multimodal_alzheimer_tpu_torch.ops.normalization import (
    normalize_mri,
    normalize_pet,
)
from multimodal_alzheimer_tpu_torch.ops.quantile import (
    host_masked_nonzero_quantile,
)

LABELS_3 = {"CN": 0, "MCI": 1, "Dementia": 2}
LABELS_2 = {"CN": 0, "Dementia": 1}

# pd.read_csv's default missing-value markers.
_NA_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})

_MODALITY_SUBSET = {
    "pet1451": "path_pet1451",
    "t1w": "path_anat",
    "tabular": "AGE",
}


def _parse_column(cells: list) -> list:
    """One column's cells as pandas would infer them: all ints -> int,
    all numbers -> float (ints with a gap too), else strings."""
    present = [c for c in cells if c is not None]
    for kind in ((int,) if len(present) == len(cells) else ()) + (float,):
        try:
            parsed = [kind(c) for c in present]
        except ValueError:
            continue
        it = iter(parsed)
        return [None if c is None else next(it) for c in cells]
    return cells


def read_manifest(path: str) -> List[Dict[str, Any]]:
    """The manifest CSV as row dicts; empty cells are ``None``."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cells = [[None if c in _NA_CELLS else c for c in row]
                 for row in reader]
    columns = [_parse_column([row[i] for row in cells])
               for i in range(len(header))]
    return [dict(zip(header, values)) for values in zip(*columns)] \
        if cells else []


class MultiModalDataset:
    def __init__(self,
                 path: str,
                 binary_classification: bool | int = False,
                 modalities: List[str] = ("pet1451", "t1w", "tabular"),
                 days_threshold: int = 180,
                 transform_pet=None,
                 transform_mri=None,
                 transform_tabular=None,
                 normalize_pet: Optional[Dict[str, float]] = None,
                 normalize_mri: Optional[Dict[str, Any]] = None,
                 quantile: float = 0.99,
                 compat_whole_brain_bug: bool = True,
                 cache_dir: Optional[str] = None,
                 cache_dtype: Optional[str] = None,
                 memoize_minmax: bool = True):
        self.entire_ds = read_manifest(path)

        if binary_classification == 2:
            binary_classification = True
        elif binary_classification == 3:
            binary_classification = False
        self.binary_classification = bool(binary_classification)
        if self.binary_classification:
            self.entire_ds = [r for r in self.entire_ds
                              if r["label"] != "MCI"]
            self.label_mapping = dict(LABELS_2)
        else:
            self.label_mapping = dict(LABELS_3)

        self.days_threshold = days_threshold
        self.modalities = list(modalities)
        if len(self.modalities) not in range(1, 4):
            raise ValueError(f"1 to 3 modalities, got {self.modalities}")
        if not all(m in _MODALITY_SUBSET for m in self.modalities):
            raise ValueError(f"modalities must be among "
                             f"{list(_MODALITY_SUBSET)}, got "
                             f"{self.modalities}")
        if len(set(self.modalities)) != len(self.modalities):
            raise ValueError(f"repeated modality in {self.modalities}")

        # Per-modality frames in canonical order (dataloader.py:108-121:
        # pet1451, t1w, tabular whatever order the caller lists them in),
        # each without the rows that lack that modality.
        frames = [[r for r in self.entire_ds
                   if r[_MODALITY_SUBSET[m]] is not None]
                  for m in ("pet1451", "t1w", "tabular")
                  if m in self.modalities]
        if len(frames) == 1:
            self.rows = frames[0]
        else:
            self.rows = expand_pairings(
                [[dict(r, ses=datetime.strptime(r["ses"], "%Y-%m-%d"))
                  for r in frame] for frame in frames], days_threshold)

        self.transform_pet = transform_pet
        self.transform_mri = transform_mri
        self.transform_tabular = transform_tabular

        self.normalize_pet = normalize_pet
        if self.normalize_pet:
            for key in ("mean", "std"):
                if not isinstance(self.normalize_pet.get(key), float):
                    raise ValueError(f"normalize_pet[{key!r}] must be a "
                                     f"float, got {self.normalize_pet}")
        self.normalize_mri = normalize_mri
        self.quantile = quantile
        self.compat_whole_brain_bug = compat_whole_brain_bug
        # Optional decoded-volume cache (data/cache.py). Volumes keep the
        # cache's (possibly half-width) dtype through collate and the copy
        # to the device; the device preprocess casts them to float32.
        self._cache = None
        self._vol_dtype = (np.dtype(cache_dtype) if cache_dtype is not None
                           else np.dtype(np.float32))
        if cache_dir is not None:
            self._cache = VolumeCache(cache_dir, dtype=cache_dtype)
        # Per-scan min-max bounds depend only on the raw volume, so they are
        # computed once per sample on the host and the step runs the apply
        # kernel alone (K2) instead of the select (K1) every step. In
        # memory always; as sidecars beside the volume cache when one is
        # configured.
        self.memoize_minmax = bool(
            memoize_minmax and self.normalize_mri
            and self.normalize_mri.get("per_scan_norm") == "min_max")
        self._minmax_memo: Dict[tuple, np.ndarray] = {}

    def _load_volume(self, path):
        if self._cache is not None:
            return self._cache.get(path)
        return load_nifti(path)

    def _minmax_bounds(self, index, mri_path, mask_path, mri, mask):
        """(2,) f32 [Q(1-q), Q(q)] of this sample, memoised.

        From exactly the arrays the device would see (after any dtype
        narrowing), with the device paths' f32 rank arithmetic. Keyed by
        (index, quantile), since ``quantile`` may be rebound between
        epochs; entries of another quantile are dropped when it changes.
        """
        q = float(self.quantile)
        if self._minmax_memo and next(iter(self._minmax_memo))[1] != q:
            self._minmax_memo = {k: v for k, v in self._minmax_memo.items()
                                 if k[1] == q}
        memo_key = (index, q)
        memo = self._minmax_memo.get(memo_key)
        if memo is not None:
            return memo
        entry = None
        if self._cache is not None:
            def stamp(p):
                # size and mtime, so a changed volume drops its sidecar
                if p is None:
                    return "none"
                st = os.stat(p)
                return f"{p}|{st.st_size}|{int(st.st_mtime)}"

            token = (f"{stamp(mri_path)}|{stamp(mask_path)}|{self.quantile}"
                     f"|{self._vol_dtype.name}|qminmax")
            entry = (self._cache.cache_dir
                     / f"{hashlib.sha1(token.encode()).hexdigest()[:24]}"
                       f".q.npy")
            if entry.exists():
                memo = np.load(entry)
        if memo is None:
            memo = host_masked_nonzero_quantile(
                mri, mask, (1.0 - self.quantile, self.quantile))
            if entry is not None:
                tmp = entry.with_suffix(f".{os.getpid()}.tmp.npy")
                np.save(tmp, memo)
                os.replace(tmp, entry)
        self._minmax_memo[memo_key] = memo
        return memo

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        """Raw (un-normalised) sample dict with the keys that have values:
        'pet1451', 'mri', 'mri_mask', 'mri_qminmax', 'tabular', 'label'."""
        sample = self.rows[index]
        data: Dict[str, Any] = {}

        pet_path = sample.get("path_pet1451")
        if pet_path is not None:
            pet = self._load_volume(pet_path)
            if self.transform_pet:
                pet = self.transform_pet(pet)
            data["pet1451"] = np.asarray(pet, dtype=self._vol_dtype)

        mri_path = sample.get("path_anat")
        if mri_path is not None:
            mri = self._load_volume(mri_path)
            if self.transform_mri:
                mri = self.transform_mri(mri)
            data["mri"] = np.asarray(mri, dtype=self._vol_dtype)
            mask_path = sample.get("path_anat_mask")
            if (self.normalize_mri and "per_scan_norm" in self.normalize_mri
                    and mask_path is not None):
                data["mri_mask"] = np.asarray(self._load_volume(mask_path),
                                              dtype=self._vol_dtype)
            # Never memoised under a transform hook: it may be a random
            # augmentation, and cached bounds would then be wrong.
            if self.memoize_minmax and self.transform_mri is None:
                data["mri_qminmax"] = self._minmax_bounds(
                    index, mri_path, mask_path, data["mri"],
                    data.get("mri_mask"))

        if sample.get("AGE") is not None:
            data["tabular"] = tabular_vector(
                sample, self.compat_whole_brain_bug)

        data["label"] = np.int32(self.label_mapping[sample["label"]])
        return data

    def host_normalized_item(self, index: int) -> Dict[str, Any]:
        """The reference's item: normalisation applied on the host, one
        scan at a time (dataloader.py:183-321)."""
        data = self[index]
        data.pop("mri_qminmax", None)  # the host path recomputes quantiles
        if "pet1451" in data and self.normalize_pet:
            data["pet1451"] = normalize_pet(
                torch.from_numpy(data["pet1451"].astype(np.float32)),
                self.normalize_pet["mean"],
                self.normalize_pet["std"]).numpy()
        if "mri" in data and self.normalize_mri:
            mask = data.pop("mri_mask", None)
            data["mri"] = normalize_mri(
                torch.from_numpy(data["mri"].astype(np.float32)),
                None if mask is None else torch.from_numpy(
                    mask.astype(np.float32)),
                self.normalize_mri, self.quantile).numpy()
        return data

    def get_device_preprocess(self):
        """``preprocess(batch) -> batch`` on the device: the raw batch dict
        to model inputs, with this dataset's normalisation; 'mri_mask' and
        'mri_qminmax' are consumed (``data/preprocess.py``)."""
        return make_device_preprocess(self.normalize_pet, self.normalize_mri,
                                      self.quantile)

    def get_label_distribution(self):
        """(counts, normalised counts) as float64 arrays ordered
        CN[/MCI]/Dementia, NaN for an absent class (dataloader.py:323-344,
        ``value_counts().reindex``)."""
        order = (["CN", "Dementia"] if self.binary_classification
                 else ["CN", "MCI", "Dementia"])
        labels = [r["label"] for r in self.rows]
        counts = np.array([labels.count(k) or np.nan for k in order],
                          dtype=np.float64)
        return counts, counts / max(len(labels), 1)


class TabularEmbeddingDataset:
    """A dataset whose samples also carry a precomputed 'tabular_embedding'.

    The reference's stage-2/3 fusions run the frozen TabPFN inside every
    training step for its decoder activations (tabular_mri_fusion.py:58-76,
    requires_grad=False at :29). A frozen model on a fixed row gives a
    constant, so it is computed once per row and served as the
    'tabular_embedding' batch key, which ``TabularMLP`` passes through to
    the fusion heads exactly.

    ``from_tabpfn`` takes a fitted ``TabPFNClassifier``; the constructor
    any (len(base), d) array. Every other attribute (device preprocess,
    label distribution, ``rows``) is the base dataset's.
    """

    def __init__(self, base, embeddings):
        embeddings = np.asarray(embeddings, np.float32)
        if len(embeddings) != len(base):
            raise ValueError(
                f"{len(embeddings)} embeddings for {len(base)} samples")
        self.base = base
        self.embeddings = embeddings

    @classmethod
    def from_tabpfn(cls, base, classifier) -> "TabularEmbeddingDataset":
        x = np.stack([base[i]["tabular"] for i in range(len(base))])
        return cls(base, classifier.embed(x.astype(np.float32)))

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        sample = dict(self.base[index])
        sample["tabular_embedding"] = self.embeddings[index]
        return sample

    def __getattr__(self, name):
        if name == "base":  # before __init__ ran (e.g. unpickling)
            raise AttributeError(name)
        return getattr(self.base, name)
