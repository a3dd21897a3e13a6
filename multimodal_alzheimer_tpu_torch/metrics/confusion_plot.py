"""Host-side confusion-matrix rendering (reference confusion_matrix.py parity).

Produces the same three artifact styles the reference saves at test time
(reference: pkg/models/base_model.py:178-212 and pkg/utils/confusion_matrix.py):
raw counts, row-normalized, and the color-branded normalized variant, plus an
RGB array suitable for TensorBoard image logging.
"""

from __future__ import annotations

import io

import numpy as np


def render_confusion_matrix(
    cm: np.ndarray,
    label_idx_by_name: dict,
    normalize: bool = False,
    legend: bool = True,
    colormap: bool = False,
):
    """Render a confusion matrix to a matplotlib Figure.

    Mirrors reference confusion_matrix.py:69-131 (seaborn heatmap, 'crest'
    colormap or the branded two-color map, row normalization when requested).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap
    import pandas as pd
    import seaborn as sns

    cm = np.asarray(cm, dtype=np.float64)
    if normalize:
        row_sums = cm.sum(axis=1, keepdims=True)
        cm = np.divide(cm, np.where(row_sums == 0, 1.0, row_sums))

    df_cm = pd.DataFrame(
        cm,
        index=list(label_idx_by_name.values()),
        columns=list(label_idx_by_name.values()),
    )
    if not legend:
        df_cm.index = list(label_idx_by_name.keys())
        df_cm.columns = list(label_idx_by_name.keys())

    if colormap:
        cmap = LinearSegmentedColormap.from_list("mycmap", ["#b0cffb", "#22418e"])
    else:
        cmap = "crest"

    if legend:
        fig, ax = plt.subplots(figsize=(10, 5))
        fig.subplots_adjust(left=0.05, right=0.65)
    else:
        fig, ax = plt.subplots()
    sns.set(font_scale=1.2)
    if normalize:
        sns.heatmap(df_cm, annot=True, annot_kws={"size": 16}, fmt=".2f",
                    ax=ax, cmap=cmap, vmin=0, vmax=1)
    else:
        sns.heatmap(df_cm.astype(int), annot=True, annot_kws={"size": 16},
                    fmt="d", ax=ax, cmap=cmap)
    plt.yticks(rotation=0)
    return fig


def save_confusion_matrix_pngs(cm: np.ndarray, label_idx_by_name: dict,
                               out_dir: str) -> list:
    """Save the three reference PNG variants (base_model.py:178-212)."""
    import matplotlib.pyplot as plt
    import os

    os.makedirs(out_dir, exist_ok=True)
    specs = [
        ("confusion_matrix.png", dict(normalize=False, legend=False)),
        ("confusion_matrix_normalized.png", dict(normalize=True, legend=False)),
        ("confusion_matrix_color_branded.png",
         dict(normalize=True, legend=False, colormap=True)),
    ]
    paths = []
    for fname, kwargs in specs:
        fig = render_confusion_matrix(cm, label_idx_by_name, **kwargs)
        path = os.path.join(out_dir, fname)
        fig.savefig(path, dpi=300, transparent=True)
        plt.close(fig)
        paths.append(path)
    return paths


def confusion_matrix_image(cm: np.ndarray, label_idx_by_name: dict) -> np.ndarray:
    """(H, W, 3) uint8 RGB image for TensorBoard (loggable variant)."""
    import matplotlib.pyplot as plt
    from PIL import Image

    fig = render_confusion_matrix(cm, label_idx_by_name, legend=False)
    buf = io.BytesIO()
    fig.savefig(buf, format="jpeg", bbox_inches="tight")
    plt.close(fig)
    buf.seek(0)
    with Image.open(buf) as im:
        return np.asarray(im.convert("RGB"))
