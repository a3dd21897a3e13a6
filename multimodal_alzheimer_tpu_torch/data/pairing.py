"""Temporal pairing of multimodal manifest rows, without pandas.

Port of ``multimodal_alzheimer_tpu/data/pairing.py:expand_pairings`` as the
reference wrote it, a nested loop over row dicts (reference:
pkg/utils/dataloader.py:124-156, find_corresponding_samples:347-396,
merge_two_dfs:398-436), which is fast enough at ADNI sizes. The semantics,
row order included, are the reference's:

  1. The base frame is the first modality present (canonical order
     pet1451 -> t1w -> tabular). ``min_time``/``max_time`` start at ``ses``.
  2. Each further modality joins on (ID, label), keeping the rows whose
     ``ses`` lies within ``days_threshold`` days of the *growing*
     [min_time, max_time] window (``timedelta.days`` floors), so every
     fused sample is pairwise within the threshold.
  3. The window grows to include the new ``ses`` (strict comparisons).
  4. Missing columns of the joined rows are filled from the base row, per
     column of the match group: if ANY match of a base row lacks a value in
     a column and the base row has one, the base value overwrites that
     column in EVERY match of the group (merge_two_dfs:431-435).

For each base row, in base order, its matches follow in the joined frame's
row order. A missing value is ``None``.
"""

from __future__ import annotations

from datetime import datetime

_KEY_COLS = ("ID", "label")
_HELPER_COLS = ("ses", "min_time", "max_time")


def _within(row: dict, ses: datetime, max_days: int) -> bool:
    return ((ses - row["min_time"]).days <= max_days
            and (row["max_time"] - ses).days <= max_days)


def _merge(row: dict, matches: list, data_cols: list) -> list:
    """The fused rows of one base row and its matches (merge_two_dfs)."""
    out = []
    for match in matches:
        fused = {k: row[k] for k in _KEY_COLS}
        fused.update({c: match.get(c) for c in data_cols})
        ses = match["ses"]
        fused["min_time"] = ses if (row["min_time"] - ses).days > 0 \
            else row["min_time"]
        fused["max_time"] = ses if (row["max_time"] - ses).days < 0 \
            else row["max_time"]
        out.append(fused)
    for col in data_cols:
        if row.get(col) is not None and any(f[col] is None for f in out):
            for fused in out:
                fused[col] = row[col]
    return out


def expand_pairings(frames: list, days_threshold: int = 180) -> list:
    """Fused rows of per-modality row lists.

    Args:
      frames: per-modality lists of row dicts in canonical modality order;
        every row has ``ID``, ``label``, a ``datetime`` ``ses`` and the data
        columns (``None`` where the row has no value).
      days_threshold: most days between any two fused acquisitions.

    Returns:
      The fused rows, each with ``min_time``/``max_time`` and no ``ses``,
      in the reference's row order.
    """
    base = []
    for row in frames[0]:
        fused = {k: v for k, v in row.items() if k != "ses"}
        fused["min_time"] = fused["max_time"] = row["ses"]
        base.append(fused)

    for right in frames[1:]:
        data_cols = [c for c in (right[0] if right else {})
                     if c not in _KEY_COLS and c not in _HELPER_COLS]
        by_key: dict = {}
        for match in right:
            by_key.setdefault((match["ID"], match["label"]), []).append(match)
        grown = []
        for row in base:
            matches = [m for m in by_key.get((row["ID"], row["label"]), ())
                       if _within(row, m["ses"], days_threshold)]
            grown.extend(_merge(row, matches, data_cols))
        base = grown
    return base
