"""Manifest builder: BIDS tree + clinical CSVs -> per-split manifest CSVs,
without pandas.

Port of ``multimodal_alzheimer_tpu/data/manifest.py``, which reimplements
the reference's offline provisioning script (reference:
pkg/utils/create_csv/data_labels.py) with configurable roots:

  * PET rows: per (subject, 'pet-AV1451', session) keep only the MNI_2mm
    file (:190); label joined from the tau/amyloid status table by
    (ID, ses, modality) (:197-199).
  * MRI rows: keep only 'reg_ants2_MNI_2mm' files (:224) plus the ANTs
    brain mask path (:227); label = diagnosis row with the smallest
    |date delta| if < 150 days (THRESHOLD_DAYS_MRI, :149, :251), mapped via
    the DXCURREN/DXCHANGE/DIAGNOSIS code table (``get_diag``, :95-126).
  * Tabular rows: the merged ADNI table filtered to split IDs, AGE
    corrected by Years_bl (:136), rows with any NaN dropped (:144).

Tables are lists of row dicts (``data/csv_table.py``), with the types
``pd.read_csv`` infers. Comparisons keep pandas' semantics: an all-digit
``RID`` column holds ints and never equals a ``sub-...`` directory name, a
tie in the closest diagnosis takes the first row, a diagnosis row without
``EXAMDATE`` is skipped. The manifest is the rows of the JAX package's
frame, and is written as its ``to_csv`` writes that frame: after the concat
of the image rows with the tabular rows, a column pandas holds as float64
(an int column with a gap, such as ``PTEDUCAT`` beside the image rows) is
written as ``16.0``, a missing value as an empty cell, ``ses`` as
``%Y-%m-%d``.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Optional, Tuple

from multimodal_alzheimer_tpu_torch.data.csv_table import (
    read_csv_rows,
    write_csv_rows,
)

THRESHOLD_DAYS_MRI = 150

MANIFEST_COLUMNS = [
    "ID", "ses", "path_pet1451", "path_anat", "path_anat_mask",
    "AGE", "PTEDUCAT", "Ventricles", "Hippocampus", "WholeBrain",
    "Entorhinal", "Fusiform", "MidTemp", "ICV", "label",
]

RELEVANT_FEATS_TAB = ["RID", "EXAMDATE", "Ventricles", "Hippocampus",
                      "WholeBrain", "Entorhinal", "Fusiform", "MidTemp",
                      "ICV", "AGE", "Years_bl", "PTEDUCAT", "DX"]


def get_timedelta_from_string(timestring: str,
                              format: str = "ses-%Y-%m-%d") -> datetime:
    return datetime.strptime(timestring, format)


def get_rid_from_id(id_string: str) -> int:
    """Patient RID = int of the ID string's last 4 chars
    (data_labels.py:50-62)."""
    return int(id_string[-4:])


def find_closest_timestamp(date: datetime, rows: list,
                           col_name: str = "EXAMDATE") -> Tuple[int, int]:
    """(days, row index in ``rows``) of the diagnosis nearest in time
    (data_labels.py:64-93); the first of equally near rows."""
    diff = [(abs((date - (datetime.strptime(row[col_name], "%Y-%m-%d")
                          if isinstance(row[col_name], str)
                          else row[col_name])).days), i)
            for i, row in enumerate(rows) if row[col_name] is not None]
    return min(diff)


def get_diag(row) -> str:
    """ADNI diagnosis codes -> CN/MCI/Dementia (data_labels.py:95-126)."""
    def eq(col, v):
        return col in row and row[col] == v

    if (eq("DXCURREN", 1) or eq("DXCHANGE", 1) or eq("DXCHANGE", 7)
            or eq("DXCHANGE", 9) or eq("DIAGNOSIS", 1)):
        return "CN"
    if (eq("DXCURREN", 2) or eq("DXCHANGE", 2) or eq("DXCHANGE", 4)
            or eq("DXCHANGE", 8) or eq("DIAGNOSIS", 2)):
        return "MCI"
    if (eq("DXCURREN", 3) or eq("DXCHANGE", 3) or eq("DXCHANGE", 5)
            or eq("DXCHANGE", 6) or eq("DIAGNOSIS", 3)):
        return "Dementia"
    return "not defined"


def load_tabular_table(adni_merged_csv: str) -> list:
    """Adni_merged.csv -> cleaned tabular rows (data_labels.py:134-145)."""
    out = []
    for row in read_csv_rows(adni_merged_csv, usecols=RELEVANT_FEATS_TAB):
        years = row.pop("Years_bl")
        row["AGE"] = (None if row["AGE"] is None or years is None
                      else row["AGE"] + years)
        row["EXAMDATE"] = datetime.strptime(row["EXAMDATE"], "%d/%m/%Y")
        if all(v is not None for v in row.values()):
            out.append(row)
    return out


def _typed(columns: dict, n: int) -> dict:
    """``{column: values}`` of ``n`` rows with each column's values cast to
    the dtype pandas infers for it (``None`` missing): all ints and none
    missing stays int, all numbers (or a gap) is float, else object."""
    out = {}
    for name, values in columns.items():
        values = values + [None] * (n - len(values))
        present = [v for v in values if v is not None]
        numbers = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                      for v in present)
        if numbers and (len(present) < n
                        or any(isinstance(v, float) for v in present)):
            values = [None if v is None else float(v) for v in values]
        out[name] = values
    return out


def _frame(rows: list) -> dict:
    """``pd.DataFrame(rows)`` as ``{column: typed values}``, columns in the
    order of their first appearance."""
    columns: dict = {}
    for i, row in enumerate(rows):
        for name in row:
            columns.setdefault(name, [None] * i)
        for name, values in columns.items():
            values.append(row.get(name))
    return _typed(columns, len(rows))


def _concat(first: dict, n_first: int, second: dict, n_second: int) -> dict:
    """``pd.concat([first, second], ignore_index=True)`` of two typed
    frames: a column that is object on either side keeps each side's
    values; a numeric one becomes float where either side is float or
    lacks it."""
    if n_first == 0 and not first:
        return dict(second)
    if n_second == 0:
        return dict(first)
    out = {}
    for name in list(first) + [k for k in second if k not in first]:
        a = first.get(name, [None] * n_first)
        b = second.get(name, [None] * n_second)
        present = [v for v in a + b if v is not None]
        object_side = any(
            not isinstance(v, (int, float)) or isinstance(v, bool)
            for v in present)
        out[name] = a + b if object_side else _typed({name: a + b},
                                                    n_first + n_second)[name]
    return out


def build_manifest(split_ids: list,
                   bids_root: str,
                   tau_status_table: Optional[list] = None,
                   diagnosis_table: Optional[list] = None,
                   tabular_table: Optional[list] = None,
                   ) -> list:
    """One split's manifest rows (the body of data_labels.py's loop), each
    a dict over ``MANIFEST_COLUMNS`` with ``None`` where it has no value.
    The tables are indexed once by their join keys (Python's ``==`` and
    hash, as pandas compares these values), first rows first."""
    ids = set(split_ids)
    tau_dx: dict = {}
    for r in tau_status_table or ():
        tau_dx.setdefault((r["ID"], r["ses"], r["pet.modality"]), r["DX"])
    diagnoses: dict = {}
    for r in diagnosis_table or ():
        diagnoses.setdefault(r["RID"], []).append(r)
    rows = []

    for subject in sorted(os.listdir(bids_root)):
        if subject not in ids:
            continue
        subject_path = os.path.join(bids_root, subject)
        modalities = os.listdir(subject_path)

        if "pet-AV1451" in modalities and tau_status_table is not None:
            base = os.path.join(subject_path, "pet-AV1451")
            for session in [s for s in os.listdir(base) if "ses" in s]:
                ses_path = os.path.join(base, session)
                files = [f for f in os.listdir(ses_path) if "MNI_2mm" in f]
                if len(files) != 1:
                    continue
                key = (subject, session, "pet-AV1451")
                if key not in tau_dx:
                    continue
                rows.append({
                    "ID": subject,
                    "ses": get_timedelta_from_string(session),
                    "path_pet1451": os.path.join(ses_path, files[0]),
                    "label": tau_dx[key],
                })

        if "anat" in modalities and diagnosis_table is not None:
            base = os.path.join(subject_path, "anat")
            for session in [s for s in os.listdir(base) if "ses" in s]:
                ses_path = os.path.join(base, session)
                files = [f for f in os.listdir(ses_path)
                         if "reg_ants2_MNI_2mm" in f]
                mask_path = os.path.join(
                    ses_path,
                    "antsCorticalThickness/"
                    "BrainExtractionMask_ants2_MNI_2mm.nii.gz")
                if len(files) != 1:
                    continue
                session_date = get_timedelta_from_string(session)
                rid = get_rid_from_id(subject)
                subject_rows = diagnoses.get(rid, [])
                if not subject_rows:
                    continue
                days, idx = find_closest_timestamp(session_date,
                                                   subject_rows)
                if days >= THRESHOLD_DAYS_MRI:
                    continue
                rows.append({
                    "ID": subject,
                    "ses": session_date,
                    "path_anat": os.path.join(ses_path, files[0]),
                    "path_anat_mask": mask_path,
                    "label": get_diag(subject_rows[idx]),
                })

    frame, n = _frame(rows), len(rows)
    if tabular_table is not None:
        rename = {"RID": "ID", "EXAMDATE": "ses", "DX": "label"}
        kept = [r for r in tabular_table if r["RID"] in ids]
        names = list(tabular_table[0]) if tabular_table else []
        frame = _concat(frame, n, {rename.get(k, k): [r[k] for r in kept]
                                   for k in names}, len(kept))
        n += len(kept)
    if n:
        frame["ses"] = [d.strftime("%Y-%m-%d") if hasattr(d, "strftime")
                        else d for d in frame["ses"]]
    return [{col: frame.get(col, [None] * n)[i] for col in MANIFEST_COLUMNS}
            for i in range(n)]


def write_manifest(path: str, rows: list) -> None:
    """The manifest rows as the JAX package's ``frame.to_csv(path,
    index=False)`` writes them."""
    write_csv_rows(path, rows, MANIFEST_COLUMNS)


def build_split_manifests(split_json: str, bids_root: str, out_dir: str,
                          tau_status_csv: Optional[str] = None,
                          diagnosis_csv: Optional[str] = None,
                          adni_merged_csv: Optional[str] = None) -> dict:
    """Write data/{train,val,test}_path_data_labels.csv
    (data_labels.py:156-274)."""
    with open(split_json) as f:
        split = json.load(f)
    tau = read_csv_rows(tau_status_csv) if tau_status_csv else None
    diag = read_csv_rows(diagnosis_csv) if diagnosis_csv else None
    tab = load_tabular_table(adni_merged_csv) if adni_merged_csv else None

    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for mode in ("train", "val", "test"):
        rows = build_manifest(split[mode], bids_root, tau, diag, tab)
        path = os.path.join(out_dir, f"{mode}_path_data_labels.csv")
        write_manifest(path, rows)
        out[mode] = path
    return out


def count_modalities(bids_root: str) -> list:
    """Modality availability census per subject
    (create_csv/count_modalities.py parity)."""
    rows = []
    for subject in sorted(os.listdir(bids_root)):
        subject_path = os.path.join(bids_root, subject)
        if not os.path.isdir(subject_path):
            continue
        mods = set(os.listdir(subject_path))
        rows.append({"ID": subject,
                     "has_pet1451": "pet-AV1451" in mods,
                     "has_anat": "anat" in mods})
    return rows
