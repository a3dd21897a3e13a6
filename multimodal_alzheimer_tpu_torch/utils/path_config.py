"""Central path registry (reference load_path_config.py parity), no yaml.

Port of ``multimodal_alzheimer_tpu/utils/path_config.py``.
``path_config.yaml`` maps dataset CSVs, the log directory and best-model
checkpoints to paths; the ``relative`` block resolves against an explicit
root, the CWD by default (reference: pkg/utils/load_path_config.py:5-24).

The file is read by a parser of the subset of YAML it uses: top-level
``key: 'value'`` lines (quoted, or plain path characters), one ``relative:``
block of indented ``key: 'value'`` lines, blank lines and ``#`` comments.
Anything else (flow lists or maps, nested blocks, a repeated key) raises,
so a file the parser does not understand is never half read.
"""

from __future__ import annotations

import re
from pathlib import Path

_KEY = r"[A-Za-z_][A-Za-z0-9_]*"
_VALUE = (r"""'(?P<single>[^']*)'|"(?P<double>[^"\\]*)"|"""
          r"(?P<plain>(?:[\w./~=+]|-(?!\s))[^#:\[\]{},]*?)")
_ENTRY = re.compile(rf"(?P<indent>\s*)(?P<key>{_KEY}):\s*(?:(?:{_VALUE})\s*)?"
                    rf"(?:#.*)?$")


def parse_path_config(text: str, source: str = "path_config.yaml") -> dict:
    """``{key: value}`` of the top level, with ``relative`` as a dict."""
    out: dict = {}
    block = None
    for number, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        match = _ENTRY.fullmatch(line)
        if match is None or "\t" in match["indent"]:
            raise ValueError(f"{source}:{number}: not a 'key: value' line "
                             f"this parser reads: {line!r}")
        key, indent = match["key"], match["indent"]
        value = next((match[g] for g in ("single", "double", "plain")
                      if match[g] is not None), None)
        if indent:
            if block is None:
                raise ValueError(f"{source}:{number}: indented line outside "
                                 f"the 'relative:' block: {line!r}")
            if value is None:
                raise ValueError(f"{source}:{number}: nested blocks are not "
                                 f"read: {line!r}")
            block[key] = value
            continue
        if key in out:
            raise ValueError(f"{source}:{number}: {key!r} given twice")
        if value is None:
            if key != "relative":
                raise ValueError(f"{source}:{number}: only 'relative:' may "
                                 f"open a block, not {key!r}")
            block = out[key] = {}
        else:
            block = None
            out[key] = value
    return out


def load_path_config(config_path: str = "path_config.yaml",
                     root: str | None = None) -> dict:
    with open(config_path, "r") as f:
        paths = parse_path_config(f.read(), str(config_path))

    base = Path(root) if root is not None else Path.cwd()
    out = {}
    if "relative" in paths:
        for key, value in paths["relative"].items():
            out[key] = base / value
    for key, value in paths.items():
        if key != "relative":
            out[key] = Path(value)
    return out
