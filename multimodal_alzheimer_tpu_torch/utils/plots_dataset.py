"""Dataset EDA plots + split sanity checks, without pandas on the checks.

Port of ``multimodal_alzheimer_tpu/utils/plots_dataset.py``, covering the
reference's notebook checks as code (reference:
notebooks_visualization/plots_dataset.py and
Sanity_Check_Data_Split.ipynb): label distributions per split, pairing
time-delta histograms, and subject-leakage verification. The checks take
what the port's readers give (manifest rows from
``data/csv_table.read_csv_rows``, paired rows from
``data/pairing.expand_pairings``); the label-distribution frame and its
plot are for rendering only and import pandas and matplotlib inside their
functions.
"""

from __future__ import annotations

from collections import Counter
from datetime import datetime

import numpy as np

from multimodal_alzheimer_tpu_torch.data import native_io
from multimodal_alzheimer_tpu_torch.data.csv_table import read_csv_rows


def _rows(manifest) -> list:
    """A manifest CSV path or rows as rows."""
    return read_csv_rows(manifest) if isinstance(manifest, str) \
        else manifest


def label_distribution_frame(manifests: dict):
    """{'train': csv path or rows, ...} -> a DataFrame of counts per
    (split, label), most frequent first within a split."""
    import pandas as pd

    rows = []
    for split, m in manifests.items():
        counts = Counter(r["label"] for r in _rows(m)
                         if r["label"] is not None)
        for label, count in counts.most_common():
            rows.append({"split": split, "label": label, "count": count})
    return pd.DataFrame(rows)


def plot_label_distribution(manifests: dict, out_path: str | None = None):
    import matplotlib
    matplotlib.use("Agg")

    frame = label_distribution_frame(manifests)
    pivot = frame.pivot_table(index="label", columns="split",
                              values="count", fill_value=0)
    ax = pivot.plot.bar(rot=0, figsize=(8, 4), color=["#22418e", "#b0cffb",
                                                      "#7a99d6"])
    ax.set_ylabel("samples")
    fig = ax.get_figure()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=200)
    return fig


def _date(value) -> datetime:
    return datetime.fromisoformat(value) if isinstance(value, str) \
        else value


def pairing_time_deltas(paired_rows: list) -> np.ndarray:
    """Days between min_time and max_time per fused sample (the pairing
    window width EDA, Exploratory_Data_Analysis.ipynb)."""
    return np.array([(_date(r["max_time"]) - _date(r["min_time"])).days
                     for r in paired_rows], dtype=np.int64)


def check_no_subject_leakage(split: dict) -> None:
    """Raise if any patient ID appears in more than one split
    (Sanity_Check_Data_Split.ipynb's core assertion)."""
    seen: dict = {}
    for name, ids in split.items():
        for pid in ids:
            if pid in seen:
                raise ValueError(
                    f"subject {pid!r} leaks across splits "
                    f"{seen[pid]!r} and {name!r}")
            seen[pid] = name


def check_manifest_shapes(manifest,
                          expected_shape=(91, 109, 91),
                          sample: int = 10) -> None:
    """Spot-check volume shapes (Image_Analysis.ipynb's assertion) of a
    manifest CSV path or rows."""
    rows = _rows(manifest)
    paths = ([r["path_pet1451"] for r in rows
              if r.get("path_pet1451") is not None]
             + [r["path_anat"] for r in rows
                if r.get("path_anat") is not None])[:sample]
    for p in paths:
        shape = native_io.nifti_shape(p)
        if tuple(shape) != tuple(expected_shape):
            raise ValueError(f"{p}: shape {shape} != {expected_shape}")
