"""CSV tables as lists of row dicts, read and written as pandas would.

The card's machine has no pandas, so the port reads the manifest and the
ADNI tables with the ``csv`` module and writes the manifests the same way.
Reading follows ``pd.read_csv``'s defaults: an empty cell (or another of its
missing-value markers) is ``None``, and a column whose every non-empty cell
is a number holds Python ints or floats, as pandas infers int64 or float64
(a column of ints with a gap becomes floats). Writing follows
``DataFrame.to_csv(index=False)``: ``None`` is an empty cell, an int is
written as ``16``, a float as its ``repr`` (``16.0``), and a field is quoted
only where it holds the delimiter, a quote or a line break.
"""

from __future__ import annotations

import csv
from typing import Any, Dict, List, Optional, Sequence

# pd.read_csv's default missing-value markers.
NA_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def parse_column(cells: list) -> list:
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


def read_csv_rows(path: str,
                  usecols: Optional[Sequence[str]] = None
                  ) -> List[Dict[str, Any]]:
    """The CSV as row dicts in file order; empty cells are ``None``.

    ``usecols`` keeps only those columns, in file order, and raises
    ``ValueError`` for a name the header lacks, as ``pd.read_csv`` does.
    """
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cells = [[None if c in NA_CELLS else c for c in row]
                 for row in reader]
    keep = range(len(header))
    if usecols is not None:
        missing = [c for c in usecols if c not in header]
        if missing:
            raise ValueError(f"Usecols do not match columns, columns "
                             f"expected but not found: {missing}")
        keep = [i for i, name in enumerate(header) if name in usecols]
    names = [header[i] for i in keep]
    columns = [parse_column([row[i] for row in cells]) for i in keep]
    return [dict(zip(names, values)) for values in zip(*columns)] \
        if cells else []


def format_cell(value) -> str:
    """One value as ``DataFrame.to_csv`` writes it."""
    if value is None:
        return ""
    return repr(value) if isinstance(value, float) else str(value)


def write_csv_rows(path: str, rows: Sequence[Dict[str, Any]],
                   columns: Sequence[str]) -> None:
    """``columns`` of ``rows`` as ``DataFrame.to_csv(path, index=False)``
    writes them (a key a row lacks is an empty cell)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([format_cell(row.get(c)) for c in columns])
