"""Performance comparison plots (reference plot_performance.py parity).

Port of ``multimodal_alzheimer_tpu/utils/plot_performance.py``, for
rendering only: matplotlib and pandas are imported inside the drawing
functions (the card's machine has neither). Scores are rows (a list of
dicts, ``None`` for a missing score), as ``collect_scores`` gives them and
``order_models`` orders them; the drawing functions take rows.

Reads scores with columns ``model, f1, f1_ci, mcc, mcc_ci`` (the
reference reads ``data/{2,3}_class_scores.csv``,
reference: notebooks_visualization/plot_performance.py:22-24) and renders
the reference's figure repertoire (:59-344):

  * grouped F1 + MCC bars per model with CI error bars clipped to [0, 1]
    (``limit_err_values`` parity, :45-57),
  * the 7-model stage layout (PET / MRI / Tabular | 3 pairwise fusions |
    all-modalities) with dashed stage dividers and Stage 1/2/3 headers
    (:105-116),
  * per-modality color coding and hatch variants (:120-196),
  * experiment-category panels (Early/CNN/FC fusion, :200-250),
  * and the side-by-side 2-targets vs 3-targets comparison figure.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Canonical model order + stage boundaries (reference :105-116)
STAGE_ORDER = ["PET", "MRI", "Tabular", "PET-MRI", "PET-Tabular",
               "MRI-Tabular", "All modalities"]
STAGE_DIVIDERS = (2.5, 5.5)
STAGE_LABELS = ((1.0, "Stage 1"), (4.0, "Stage 2"), (6.0, "Stage 3"))
# Per-modality color code (reference :139 kwargs color vector)
MODALITY_COLORS = ["#234B04", "#8DB66B", "#C7D8B8", "#164194", "#7996D4",
                   "#A8D0FE", "#884C7C"]
F1_COLOR, MCC_COLOR = "#7f96cf", "#b0cffb"


def limit_err_values(values, cis, eps: float = 0.001) -> np.ndarray:
    """Asymmetric error bars clipped to the metric's [0, 1] range
    (reference limit_err_values, :45-57)."""
    values = np.asarray(values, float)
    cis = np.asarray(cis, float)
    lower = np.where(values - cis < eps, values - eps, cis)
    upper = np.where(values + cis > 1 - eps, 1 - values - eps, cis)
    return np.stack([lower, upper])


def _frame(scores: list):
    """Scores rows as a DataFrame."""
    import pandas as pd

    return pd.DataFrame(scores)


def _grouped_bars(ax, df, colors_f1, colors_mcc, hatches=None,
                  edgecolor="black"):
    x = np.arange(len(df))
    width = 0.3
    err_f1 = limit_err_values(df["f1"], df.get("f1_ci", 0.0))
    err_mcc = limit_err_values(df["mcc"], df.get("mcc_ci", 0.0))
    bars_f1 = ax.bar(x - width / 2, df["f1"], width, yerr=err_f1,
                     capsize=2, color=colors_f1, ecolor="black",
                     edgecolor=edgecolor,
                     hatch=hatches[0] if hatches else None)
    bars_mcc = ax.bar(x + width / 2, df["mcc"], width, yerr=err_mcc,
                      capsize=2, color=colors_mcc, ecolor="black",
                      edgecolor=edgecolor,
                      hatch=hatches[1] if hatches else None)
    ax.set_xticks(x)
    ax.set_xticklabels(df["model"], rotation=45, ha="right")
    ax.set_ylim(0, 1.0)
    ax.set_ylabel("Score")
    ax.spines[["right", "top"]].set_visible(False)
    return bars_f1, bars_mcc


def _stage_annotations(ax, dividers=STAGE_DIVIDERS, labels=STAGE_LABELS):
    ax.vlines(list(dividers), ymin=0, ymax=1, color="black",
              linestyles="dashed", linewidth=3)
    for pos, text in labels:
        ax.text(pos, 1.02, text, fontweight="bold", va="bottom",
                ha="center")


def plot_stage_comparison(df, binary: bool = True,
                          color_by_modality: bool = False,
                          hatches: Optional[tuple] = None,
                          legend: bool = True, ax=None,
                          out_path: Optional[str] = None):
    """Reference plot_bar / plot_bar_colorcoded: grouped F1+MCC bars in
    the 7-model stage layout with dividers and stage headers
    (reference :59-196)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = _frame(order_models(df))
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(12, 6))
    else:
        fig = ax.figure
    if color_by_modality:
        colors = [MODALITY_COLORS[i % len(MODALITY_COLORS)]
                  for i in range(len(df))]
        bars_f1, bars_mcc = _grouped_bars(ax, df, colors, colors,
                                          hatches=hatches or ("//", ".."))
    else:
        bars_f1, bars_mcc = _grouped_bars(ax, df, F1_COLOR, MCC_COLOR,
                                          hatches=hatches)
    _stage_annotations(ax)
    ax.set_xlabel("2 Targets" if binary else "3 Targets",
                  fontweight="bold", labelpad=10)
    if legend:
        if color_by_modality:
            h1 = matplotlib.patches.Patch(
                facecolor=(0, 0, 0, 0), edgecolor="black",
                hatch=(hatches or ("//", ".."))[0])
            h2 = matplotlib.patches.Patch(
                facecolor=(0, 0, 0, 0), edgecolor="black",
                hatch=(hatches or ("//", ".."))[1])
            ax.legend(handles=[h1, h2], labels=["F1", "MCC"],
                      loc="center left", bbox_to_anchor=(1.0, 0.9),
                      frameon=False)
        else:
            ax.legend(handles=[bars_f1, bars_mcc], labels=["F1", "MCC"],
                      loc="center left", bbox_to_anchor=(1.0, 0.9),
                      frameon=False)
    if own_fig:
        fig.tight_layout()
        if out_path:
            fig.savefig(out_path, dpi=200, bbox_inches="tight")
    return fig, ax


def plot_experiment_comparison(df, categories: Sequence[tuple],
                               binary: bool = True,
                               out_path: Optional[str] = None):
    """Reference plot_bar_exp: F1+MCC bars split into experiment
    categories (e.g. Early/CNN/FC fusion) by dashed dividers
    (reference :200-250). ``categories`` = [(label, n_models), ...] in
    frame order."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 6))
    bars_f1, bars_mcc = _grouped_bars(ax, _frame(df), F1_COLOR, MCC_COLOR)
    edges = np.cumsum([n for _, n in categories])[:-1] - 0.5
    ax.vlines(edges, ymin=0, ymax=1, color="black", linestyles="dashed",
              linewidth=3)
    start = 0
    for label, n in categories:
        ax.text(start + (n - 1) / 2, 1.02, label, fontweight="bold",
                va="bottom", ha="center")
        start += n
    ax.set_xlabel("2 Targets" if binary else "3 Targets",
                  fontweight="bold", labelpad=10)
    ax.legend(handles=[bars_f1, bars_mcc], labels=["F1", "MCC"],
              loc="center left", bbox_to_anchor=(1.0, 0.9), frameon=False)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=200, bbox_inches="tight")
    return fig, ax


def plot_two_vs_three(df_2_class, df_3_class,
                      color_by_modality: bool = False,
                      out_path: Optional[str] = None):
    """The grouped 2-targets vs 3-targets comparison figure: two stage
    panels side by side sharing the y axis — the reference renders these
    as separate figures from {2,3}_class_scores.csv; this emits the
    combined comparison directly from collected test metrics."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(22, 6), sharey=True)
    plot_stage_comparison(df_2_class, binary=True, legend=False,
                          color_by_modality=color_by_modality, ax=axes[0])
    plot_stage_comparison(df_3_class, binary=False, legend=True,
                          color_by_modality=color_by_modality, ax=axes[1])
    axes[1].set_ylabel("")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=200, bbox_inches="tight")
    return fig, axes


def order_models(scores: list) -> list:
    """Reorder scores rows into the canonical stage order; unknown model
    names keep their relative position at the end."""
    rank = {name: i for i, name in enumerate(STAGE_ORDER)}
    return sorted(scores, key=lambda r: rank.get(r["model"], len(rank)))


def plot_scores(scores, metric: str = "f1",
                title: str = "", out_path: str | None = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scores = _frame(scores)
    ci_col = f"{metric}_ci"
    fig, ax = plt.subplots(figsize=(10, 5))
    x = np.arange(len(scores))
    ax.bar(x, scores[metric],
           yerr=scores[ci_col] if ci_col in scores else None,
           capsize=4, color="#22418e")
    ax.set_xticks(x)
    ax.set_xticklabels(scores["model"], rotation=30, ha="right")
    ax.set_ylabel(metric.upper())
    ax.set_ylim(0, 1)
    ax.set_title(title)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=200)
    return fig


def collect_scores(metric_dicts: dict) -> list:
    """{model_name: trainer.test(...) metrics} -> scores rows."""
    rows = []
    for name, m in metric_dicts.items():
        rows.append({
            "model": name,
            "f1": m.get("test_f1_epoch_boot", m.get("test_f1_epoch")),
            "f1_ci": m.get("test_f1_epoch_ci", 0.0),
            "mcc": m.get("test_mcc_epoch_boot"),
            "mcc_ci": m.get("test_mcc_epoch_ci", 0.0),
        })
    return rows
