"""Synthetic ADNI-like fixtures: manifests, NIfTI volumes, labeled arrays.

Port of ``multimodal_alzheimer_tpu/data/synthetic.py`` without pandas: the
same numpy draws from the same seed in the same order, so both packages
write the same manifest rows and the same volumes, and ``pd.read_csv``
reads the port's manifest CSV as the JAX package's. A manifest is a list of
row dicts with ``None`` where a row has no value.
"""

from __future__ import annotations

import os
from datetime import datetime, timedelta

import numpy as np

from multimodal_alzheimer_tpu_torch.data.csv_table import write_csv_rows
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
    write_csv_rows(path, rows, MANIFEST_COLUMNS)


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


# ADNI diagnosis codes of each label, one per coding column (get_diag):
# DXCURREN (ADNI1), DXCHANGE (ADNI2, conversions included), DIAGNOSIS
# (ADNI3).
DX_CODES = {"CN": (("DXCURREN", 1), ("DXCHANGE", 1), ("DXCHANGE", 7),
                   ("DXCHANGE", 9), ("DIAGNOSIS", 1)),
            "MCI": (("DXCURREN", 2), ("DXCHANGE", 2), ("DXCHANGE", 4),
                    ("DXCHANGE", 8), ("DIAGNOSIS", 2)),
            "Dementia": (("DXCURREN", 3), ("DXCHANGE", 3), ("DXCHANGE", 5),
                         ("DXCHANGE", 6), ("DIAGNOSIS", 3))}
# Subject labels, cycled within each split: every split of four or more
# subjects holds both binary classes.
ADNI_LABELS = ("CN", "Dementia", "CN", "Dementia", "MCI")
ADNI_TAB_FEATURES = ("Ventricles", "Hippocampus", "WholeBrain", "Entorhinal",
                     "Fusiform", "MidTemp", "ICV")


def _brain_volumes(rng, shape):
    """(T1w float32, brain mask uint8): an ellipsoid brain of N(900, 400)
    intensities, zero outside it, as a skull-stripped MNI volume is."""
    radius = 0.8 + rng.uniform(-0.05, 0.05)
    grids = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                        indexing="ij")
    mask = (sum(g ** 2 for g in grids) < radius ** 2).astype(np.uint8)
    t1w = rng.normal(900, 400, shape).astype(np.float32) * mask
    return t1w, mask


def write_synthetic_adni(root: str, n_subjects: int = 40, seed: int = 0,
                         volume_shape=(91, 109, 91)) -> dict:
    """A raw ADNI layout for ``tools/prepare_data.py`` under ``root``.

    ``bids/`` holds ``sub-NNNN/anat/ses-YYYY-MM-DD/`` T1w volumes
    (``..._reg_ants2_MNI_2mm.nii.gz``, float32) with their brain masks
    (``antsCorticalThickness/BrainExtractionMask_ants2_MNI_2mm.nii.gz``,
    uint8), one or two sessions a subject, and ``pet-AV1451`` sessions for
    the val and test subjects and every third training subject. Beside it:
    ``Adni_merged.csv`` (its ``RID`` holds the directory names, a row per
    session, ``EXAMDATE`` as %d/%m/%Y), the tau status table and the
    ``DXSUM`` diagnosis table (int ``RID``, ADNI codes, %Y-%m-%d).

    Labels follow the patient split ``prepare_data`` will draw (seeds
    3551/4381 over the ``RID`` column), cycled through ``ADNI_LABELS`` in
    each split, so that every split holds CN and Dementia and the test
    subjects pair all three modalities. The first training subjects take
    the provisioning's edge cases: a diagnosis 200 days from the scan
    (dropped), no diagnosis (dropped), two equally near diagnoses (the
    first row wins), a diagnosis without a date (skipped), a PET session
    without a tau row and one with two MNI files (both skipped), and an
    ``Adni_merged`` row with a gap (dropped). A subject outside the table
    (``sub-9999``) and decoy files (``..._native.nii.gz``, empty) are never
    read. Returns the paths: ``bids_root``, ``adni_merged``,
    ``tau_status``, ``diagnosis``.
    """
    from multimodal_alzheimer_tpu_torch.data.split import split_ids

    rng = np.random.default_rng(seed)
    bids = os.path.join(root, "bids")
    subjects = [f"sub-{2000 + i}" for i in range(n_subjects)]
    split = split_ids(subjects)
    label_of = {sub: ADNI_LABELS[i % len(ADNI_LABELS)]
                for ids in split.values() for i, sub in enumerate(ids)}
    train = split["train"]
    edge = dict(zip(("far", "undiagnosed", "tie", "undated", "untaued",
                     "two_mni", "gap"), train))
    with_pet = set(split["val"] + split["test"] + train[::3] + train[4:6])
    merged, tau, dxsum = [], [], []

    def touch(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()

    def dx_row(rid, date, label, code=0):
        column, value = DX_CODES[label][code % len(DX_CODES[label])]
        return {"RID": rid, "EXAMDATE": date, "DXCURREN": None,
                "DXCHANGE": None, "DIAGNOSIS": None, column: value}

    for subject in subjects:
        label, rid = label_of[subject], int(subject[-4:])
        other = "CN" if label != "CN" else "Dementia"
        base = datetime(2015, 1, 1) + timedelta(days=int(rng.integers(0,
                                                                   1500)))
        age = float(np.round(rng.uniform(60, 85), 1))
        for k in range(int(rng.integers(1, 3))):
            date = base + timedelta(days=400 * k)
            ses_dir = os.path.join(bids, subject, "anat",
                                   date.strftime("ses-%Y-%m-%d"))
            os.makedirs(os.path.join(ses_dir, "antsCorticalThickness"))
            t1w, mask = _brain_volumes(rng, volume_shape)
            stem = f"{subject}_{date:ses-%Y-%m-%d}_T1w"
            save_nifti(os.path.join(ses_dir,
                                    f"{stem}_reg_ants2_MNI_2mm.nii.gz"), t1w)
            save_nifti(os.path.join(
                ses_dir, "antsCorticalThickness",
                "BrainExtractionMask_ants2_MNI_2mm.nii.gz"), mask)
            touch(os.path.join(ses_dir, f"{stem}_native.nii.gz"))
            near = date + timedelta(days=int(rng.integers(-60, 61)))
            if subject == edge.get("far"):
                dxsum.append(dx_row(rid, (date + timedelta(days=200))
                                    .strftime("%Y-%m-%d"), label))
            elif subject == edge.get("tie"):
                for days, dx in ((-10, label), (10, other)):
                    dxsum.append(dx_row(rid, (date + timedelta(days=days))
                                        .strftime("%Y-%m-%d"), dx))
            elif subject != edge.get("undiagnosed"):
                if subject == edge.get("undated"):
                    dxsum.append(dx_row(rid, None, other))
                dxsum.append(dx_row(rid, near.strftime("%Y-%m-%d"), label,
                                    int(rng.integers(0, 5))))
            visit = date + timedelta(days=int(rng.integers(-30, 31)))
            merged.append({
                "RID": subject, "VISCODE": f"m{12 * k:02d}",
                "EXAMDATE": visit.strftime("%d/%m/%Y"),
                **{f: float(np.round(rng.uniform(1e3, 1e6), 1))
                   for f in ADNI_TAB_FEATURES},
                "AGE": age,
                "Years_bl": float(np.round(k * 400 / 365.25, 2)),
                "PTEDUCAT": int(rng.integers(8, 21)), "DX": label})
        if subject == edge.get("gap"):
            merged[-1]["Ventricles"] = None
        if subject in with_pet:
            pet_date = base + timedelta(days=int(rng.integers(-60, 61)))
            sessions = [pet_date]
            if subject in (edge.get("untaued"), edge.get("two_mni")):
                sessions.append(pet_date + timedelta(days=300))
            for j, date in enumerate(sessions):
                session = date.strftime("ses-%Y-%m-%d")
                ses_dir = os.path.join(bids, subject, "pet-AV1451", session)
                os.makedirs(ses_dir)
                name = f"{subject}_{session}_pet"
                if j == 0:
                    pet = (rng.normal(0.5, 0.5, volume_shape)
                           .astype(np.float32)
                           * _brain_volumes(rng, volume_shape)[1])
                    save_nifti(os.path.join(ses_dir, f"{name}_MNI_2mm.nii.gz"),
                               pet)
                    tau.append({"ID": subject, "ses": session,
                                "pet.modality": "pet-AV1451", "DX": label})
                elif subject == edge["untaued"]:  # no tau row: skipped
                    touch(os.path.join(ses_dir, f"{name}_MNI_2mm.nii.gz"))
                else:  # two MNI files: skipped
                    touch(os.path.join(ses_dir, f"{name}_MNI_2mm.nii.gz"))
                    touch(os.path.join(ses_dir, f"{name}_MNI_2mm_2.nii.gz"))
                touch(os.path.join(ses_dir, f"{name}_native.nii.gz"))
    touch(os.path.join(bids, "sub-9999", "anat", "ses-2018-01-01",
                       "sub-9999_T1w_reg_ants2_MNI_2mm.nii.gz"))

    paths = {"bids_root": bids,
             "adni_merged": os.path.join(root, "Adni_merged.csv"),
             "tau_status": os.path.join(
                 root, "ADNI_Tau_Amyloid_SUVR_amyloid_tau_status_dems.csv"),
             "diagnosis": os.path.join(root, "DXSUM_PDXCONV_ADNIALL.csv")}
    for key, rows in (("adni_merged", merged), ("tau_status", tau),
                      ("diagnosis", dxsum)):
        write_csv_rows(paths[key], rows, list(rows[0]))
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
