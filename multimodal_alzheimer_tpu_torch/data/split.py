"""Patient-level train/val/test split (reference DataSplit.py parity), no
pandas.

Port of ``multimodal_alzheimer_tpu/data/split.py``: 10% of patient IDs to
test (seed 3551), then 10% of the remainder to val (seed 4381), so the same
Adni_merged.csv yields the identical ``data_set_split.json`` (reference:
pkg/utils/DataSplit.py:6-25). ``pandas.Series.sample(frac=0.1,
random_state=s)`` draws ``np.random.RandomState(s).permutation(n)`` and
keeps its first ``round(0.1 * n)`` positions (Python's round, half to
even); ``drop`` removes those rows and keeps the rest in order.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

from multimodal_alzheimer_tpu_torch.data.csv_table import read_csv_rows


def _sample(ids: list, seed: int) -> tuple:
    """(sampled, rest) as ``Series.sample(frac=0.1, random_state=seed)``
    and ``Series.drop`` of its index give them."""
    n = len(ids)
    picked = np.random.RandomState(seed).permutation(n)[:round(0.1 * n)]
    dropped = set(picked.tolist())
    return ([ids[i] for i in picked],
            [x for i, x in enumerate(ids) if i not in dropped])


def split_ids(ids: Sequence) -> dict:
    ids = list(dict.fromkeys(ids))  # drop_duplicates: first one kept
    test, ids = _sample(ids, 3551)
    val, train = _sample(ids, 4381)
    return {"train": train, "val": val, "test": test}


def split_tabular(path: str, out_path: str = "data_set_split.json") -> dict:
    nan = float("nan")  # one object: drop_duplicates keeps one NaN
    split = split_ids([nan if row["RID"] is None else row["RID"]
                       for row in read_csv_rows(path)])
    with open(out_path, "w") as f:
        json.dump(split, f)
    return split
