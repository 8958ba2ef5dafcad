"""Classifier figure writers with the reference's file names (role of
xgan/io_/figures_classifier.py), drawn by ``xgan_torch.io_.plots``:
{prefix}loss_curve.png, {prefix}accuracy_curve.png,
{prefix}synthetic_ratio_curve.png, {prefix}cv_test_metrics_per_fold.png,
{prefix}cv_test_loss_per_fold.png.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from xgan_torch.io_ import plots
from xgan_torch.utils import check_create_dir

BLUE, ORANGE, RED = "#0000ff", "#ffa500", "#ff0000"  # matplotlib's names


def _mean_over_common(series):
    """Fold histories can have unequal epoch counts (fold-level resume of
    a run whose --epochs changed): average over the common prefix."""
    n = min(len(s) for s in series)
    return np.mean([s[:n] for s in series], axis=0)


def _plot_curves(histories: List[Dict], train_key: str, val_key: str,
                 title: str, ylabel: str, path: str, run_prefix: str,
                 ratio_only: bool = False):
    lines, train_series, val_series = [], [], []
    for h in histories:
        if ratio_only:
            vals = h.get("synthetic_ratio", [])
            if not vals:
                continue
            lines.append(plots.Line(range(1, len(vals) + 1), vals, BLUE,
                                    alpha=0.3))
            train_series.append(vals)
        else:
            tv = h.get(train_key, [])
            vv = h.get(val_key, [])
            if not tv:
                continue
            ep = range(1, len(tv) + 1)
            lines.append(plots.Line(ep, tv, BLUE, alpha=0.3))
            if vv:
                lines.append(plots.Line(ep, vv, ORANGE, alpha=0.3))
            train_series.append(tv)
            if vv:
                val_series.append(vv)
    if not train_series:
        print(f"Warning: no data for {title}; skipping plot.")
        return

    avg_t = _mean_over_common(train_series)
    ep = range(1, len(avg_t) + 1)
    if ratio_only:
        lines.append(plots.Line(ep, avg_t, BLUE, width=3,
                                label="Average Ratio"))
    else:
        lines.append(plots.Line(ep, avg_t, BLUE, width=3,
                                label="Average Training"))
        if val_series:
            avg_v = _mean_over_common(val_series)
            lines.append(plots.Line(range(1, len(avg_v) + 1), avg_v, ORANGE,
                                    width=3, label="Average Validation"))
    canvas, _ = plots.chart(
        lines, title=f"{title} - {run_prefix}" if run_prefix else title,
        xlabel="Epoch", ylabel=ylabel)
    plots.save_png(canvas, path)
    print(f"Saved {path}")


_CV_METRICS = [("accuracy", "Accuracy"), ("weighted_precision", "Precision"),
               ("weighted_recall", "Recall"), ("weighted_f1_score",
                                               "F1 score")]


def plot_cv_bars(cv_results: Dict, figures_dir: str, run_prefix: str):
    folds = cv_results.get("folds", [])
    if not folds:
        return
    index = np.arange(len(folds))
    ticks = (index, [f"Fold {i + 1}" for i in range(len(folds))])

    bar_w = 0.2
    series = []
    for i, (key, label) in enumerate(_CV_METRICS):
        vals = [m.get(key, 0.0) for m in folds]
        series.append(plots.Bars(index + i * bar_w - 1.5 * bar_w, vals,
                                 bar_w, plots.CYCLE[i], alpha=0.8,
                                 label=label))
        avg = cv_results.get("average", {}).get(key)
        if avg is not None:
            series.append(plots.Line([index[0] - bar_w,
                                      index[-1] + 4 * bar_w], [avg, avg],
                                     plots.CYCLE[i], style="--",
                                     label=f"Avg {label}: {avg:.3f}"))
    canvas, _ = plots.chart(
        series, title="Test Set Performance Metrics per Fold "
                      "(Cross-Validation)",
        xlabel="Fold", ylabel="Score", xticks=ticks, ylim=(0, 1.05),
        grid_style="--", size=(1200, 700))
    path = os.path.join(figures_dir,
                        f"{run_prefix}cv_test_metrics_per_fold.png")
    plots.save_png(canvas, path)
    print(f"Saved metrics plot to {path}")

    losses = [m.get("loss", np.nan) for m in folds]
    if not all(np.isnan(losses)):
        series = [plots.Bars(index, losses, 0.8, plots.CYCLE[0], alpha=0.8,
                             label="Test Loss")]
        avg = cv_results.get("average", {}).get("loss")
        if avg is not None:
            series.append(plots.Line([index[0] - 0.5, index[-1] + 0.5],
                                     [avg, avg], RED, style="--",
                                     label=f"Avg Loss: {avg:.4f}"))
        canvas, _ = plots.chart(
            series, title="Test Set Loss per Fold (Cross-Validation)",
            xlabel="Fold", ylabel="Loss", xticks=ticks, grid_style="--")
        path = os.path.join(figures_dir,
                            f"{run_prefix}cv_test_loss_per_fold.png")
        plots.save_png(canvas, path)
        print(f"Saved loss plot to {path}")


def generate_plots(histories: List[Dict], figures_dir: str, run_prefix: str,
                   cv_results: Dict = None):
    """All per-run figures; histories is one dict (single run) or one per
    fold (CV)."""
    check_create_dir(figures_dir)
    _plot_curves(histories, "train_loss", "val_loss", "Training Loss",
                 "Loss", os.path.join(figures_dir,
                                      f"{run_prefix}loss_curve.png"),
                 run_prefix)
    _plot_curves(histories, "train_acc", "val_acc", "Training Accuracy",
                 "Accuracy", os.path.join(
                     figures_dir, f"{run_prefix}accuracy_curve.png"),
                 run_prefix)
    if any(h.get("synthetic_ratio") for h in histories):
        _plot_curves(histories, "", "", "Synthetic Data Ratio", "Ratio",
                     os.path.join(figures_dir,
                                  f"{run_prefix}synthetic_ratio_curve.png"),
                     run_prefix, ratio_only=True)
    if cv_results:
        plot_cv_bars(cv_results, figures_dir, run_prefix)
