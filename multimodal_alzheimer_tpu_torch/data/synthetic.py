"""Synthetic ADNI-like fixtures: manifests, NIfTI volumes, labeled arrays.

Port of ``multimodal_alzheimer_tpu/data/synthetic.py`` without pandas: the
same numpy draws from the same seed in the same order, so both packages
write the same manifest rows and the same volumes, and ``pd.read_csv``
reads the port's manifest CSV as the JAX package's. A manifest is a list of
row dicts with ``None`` where a row has no value.
"""

from __future__ import annotations

import csv
import os
from datetime import datetime, timedelta

import numpy as np

from multimodal_alzheimer_tpu_torch.data.nifti import save_nifti

MANIFEST_COLUMNS = [
    "ID", "ses", "path_pet1451", "path_anat", "path_anat_mask",
    "AGE", "PTEDUCAT", "Ventricles", "Hippocampus", "WholeBrain",
    "Entorhinal", "Fusiform", "MidTemp", "ICV", "label",
]

LABELS = ["CN", "MCI", "Dementia"]


def make_manifest_frame(n_subjects: int = 6,
                        seed: int = 0,
                        image_dir: str | None = None,
                        volume_shape=(19, 23, 17),
                        write_volumes: bool = False,
                        max_sessions: int = 3) -> list:
    """Random manifest rows: one per (subject, session, modality).

    With ``write_volumes``, real NIfTI files are written under
    ``image_dir`` and the path columns point at them; otherwise the path
    columns hold placeholder names (enough for pairing).
    """
    rng = np.random.default_rng(seed)
    rows = []
    base_date = datetime(2018, 1, 1)
    for s in range(n_subjects):
        subject = f"sub-{1000 + s}"
        label = LABELS[rng.integers(0, 3)]
        for modality in ("pet1451", "t1w", "tabular"):
            n_ses = int(rng.integers(1, max_sessions + 1))
            for _ in range(n_ses):
                day = int(rng.integers(0, 720))
                ses = (base_date + timedelta(days=day)).strftime("%Y-%m-%d")
                row = dict.fromkeys(MANIFEST_COLUMNS)
                row["ID"] = subject
                row["ses"] = ses
                # now and then a session's label differs, which exercises
                # the same-label join constraint
                row["label"] = (LABELS[rng.integers(0, 3)]
                                if rng.random() < 0.15 else label)
                if modality == "pet1451":
                    path = f"{subject}_{ses}_pet_MNI_2mm.nii.gz"
                    if write_volumes:
                        path = os.path.join(image_dir, path)
                        vol = rng.normal(0.5, 0.5, volume_shape).astype(
                            np.float32)
                        save_nifti(path, vol)
                    row["path_pet1451"] = path
                elif modality == "t1w":
                    path = f"{subject}_{ses}_T1w_reg_ants2_MNI_2mm.nii.gz"
                    mask_path = f"{subject}_{ses}_BrainExtractionMask.nii.gz"
                    if write_volumes:
                        path = os.path.join(image_dir, path)
                        mask_path = os.path.join(image_dir, mask_path)
                        vol = (rng.normal(900, 400, volume_shape)
                               .astype(np.float32))
                        mask = (rng.random(volume_shape) > 0.35).astype(
                            np.float32)
                        save_nifti(path, vol * (mask > 0))
                        save_nifti(mask_path, mask)
                    row["path_anat"] = path
                    row["path_anat_mask"] = mask_path
                else:
                    row["AGE"] = float(rng.uniform(60, 90))
                    row["PTEDUCAT"] = float(rng.integers(8, 21))
                    row["Ventricles"] = float(rng.uniform(1e4, 1e5))
                    row["Hippocampus"] = float(rng.uniform(4e3, 1.1e4))
                    row["WholeBrain"] = float(rng.uniform(8e5, 1.2e6))
                    row["Entorhinal"] = float(rng.uniform(1e3, 5e3))
                    row["Fusiform"] = float(rng.uniform(1e4, 3e4))
                    row["MidTemp"] = float(rng.uniform(1e4, 3e4))
                    row["ICV"] = float(rng.uniform(1.2e6, 2e6))
                rows.append(row)
    return rows


def write_manifest(rows: list, path: str) -> None:
    """The rows as a CSV in ``MANIFEST_COLUMNS`` order, as pandas'
    ``to_csv(index=False)`` writes them: empty cells for ``None``, floats
    in their shortest round-trip form."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(MANIFEST_COLUMNS)
        for row in rows:
            writer.writerow(["" if row[c] is None else repr(row[c])
                             if isinstance(row[c], float) else row[c]
                             for c in MANIFEST_COLUMNS])


def write_synthetic_split(out_dir: str,
                          n_subjects=(12, 4, 4),
                          seed: int = 0,
                          volume_shape=(19, 23, 17),
                          write_volumes: bool = True) -> dict:
    """Write train/val/test manifest CSVs (and volumes) under ``out_dir``.

    Returns {'train': csv_path, 'val': ..., 'test': ...} in the reference's
    data/{mode}_path_data_labels.csv layout (data_labels.py:272-274).
    """
    os.makedirs(out_dir, exist_ok=True)
    image_dir = os.path.join(out_dir, "images")
    os.makedirs(image_dir, exist_ok=True)
    paths = {}
    for i, mode in enumerate(("train", "val", "test")):
        rows = make_manifest_frame(
            n_subjects=n_subjects[i], seed=seed + i, image_dir=image_dir,
            volume_shape=volume_shape, write_volumes=write_volumes)
        csv_path = os.path.join(out_dir, f"{mode}_path_data_labels.csv")
        write_manifest(rows, csv_path)
        paths[mode] = csv_path
    return paths


def make_labeled_volumes(n: int,
                         shape=(91, 109, 91),
                         n_classes: int = 3,
                         seed: int = 0,
                         contrast: float = 0.8,
                         contrast_jitter: float = 0.0,
                         modalities=("mri",),
                         tabular_dim: int = 9) -> dict:
    """Labeled synthetic volumes with a learnable class signal.

    Class k brightens the k-th axial slab of the volume by
    ``1 + contrast``: a spatial pattern that survives the per-scan
    normalisation, where a global mean shift would not. A per-sample
    contrast jitter makes some samples ambiguous.

    Returns a dict of stacked arrays: ``label`` plus, per requested
    modality, ``mri``+``mri_mask`` (ADNI-like intensities ~N(900,200)),
    ``pet1451`` (~N(0.5, 0.25)), and/or ``tabular`` ((n, tabular_dim),
    class-shifted means).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    out = {"label": labels}
    slabs = np.array_split(np.arange(shape[0]), n_classes)
    per_sample = np.clip(
        rng.normal(contrast, contrast_jitter, n), 0.0, None)

    def brighten(vols):
        for i, k in enumerate(labels):
            vols[i, slabs[k]] *= 1.0 + per_sample[i]
        return vols

    if "mri" in modalities:
        mri = np.abs(rng.normal(900, 200, (n,) + shape)).astype(np.float32)
        out["mri"] = brighten(mri)
        out["mri_mask"] = (rng.random((n,) + shape) > 0.35).astype(
            np.float32)
    if "pet1451" in modalities:
        pet = rng.normal(0.5, 0.25, (n,) + shape).astype(np.float32)
        out["pet1451"] = brighten(pet)
    if "tabular" in modalities:
        tab = rng.normal(size=(n, tabular_dim)).astype(np.float32)
        out["tabular"] = tab + labels[:, None].astype(np.float32)
    return out


class ArrayDataset:
    """Indexable dataset over ``make_labeled_volumes``-style stacked
    arrays (what ``data.pipeline.DataLoader`` consumes)."""

    def __init__(self, data: dict):
        self.data = data
        self.n = len(data["label"])

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.data.items()}
