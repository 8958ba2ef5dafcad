"""Metrics JSON writers (copy of xgan/io_/metrics.py's classifier part).

The JSON files are the reference's public schema, read by its analyzer:

- {fold_N_}{strategy}_training_history.json: epoch, train_loss,
  train_acc, val_loss, val_acc, synthetic_ratio;
- {strategy}_cv_summary.json: {folds, average, std_dev};
- {strategy}_final_metrics.json: {config, metrics}.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def _pyify(obj):
    if isinstance(obj, dict):
        return {k: _pyify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pyify(v) for v in obj]
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.ndarray):
        return [_pyify(v) for v in obj.tolist()]
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj


def write_json(path: str, payload: dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(_pyify(payload), f, indent=4)
    print(f"Saved metrics to {path}")


def cv_summary(fold_metrics: list[dict[str, float]]) -> dict[str, Any]:
    """{folds, average, std_dev} over the folds' test metrics."""
    keys = fold_metrics[0].keys()
    return {
        "folds": fold_metrics,
        "average": {k: float(np.mean([m[k] for m in fold_metrics]))
                    for k in keys},
        "std_dev": {k: float(np.std([m[k] for m in fold_metrics]))
                    for k in keys},
    }
