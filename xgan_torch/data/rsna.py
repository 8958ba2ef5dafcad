"""RSNA pneumonia metadata (role of xgan/data/rsna.py), read with the
standard library's ``csv`` module.

Labels follow the reference data layer exactly:

- train: label 1 iff ``class == "Lung Opacity"``;
- test:  label 1 iff ``PredictionString.strip() != "0.5 0 0 100 100"``.

Layout checked:
  <data_dir>/stage2_train_metadata.csv
  <data_dir>/stage2_test_metadata.csv
  <data_dir>/Training/Images/*.png
  <data_dir>/Test/*.png
"""
from __future__ import annotations

import csv
import os

import numpy as np

NEGATIVE_PREDICTION = "0.5 0 0 100 100"
POSITIVE_CLASS = "Lung Opacity"


def _read(csv_path: str, column: str):
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [r["patientId"] for r in rows], [r[column] for r in rows]


def load_train_metadata(csv_path: str) -> tuple[list[str], np.ndarray]:
    ids, classes = _read(csv_path, "class")
    return ids, np.array([c == POSITIVE_CLASS for c in classes], np.int32)


def load_test_metadata(csv_path: str) -> tuple[list[str], np.ndarray]:
    ids, preds = _read(csv_path, "PredictionString")
    return ids, np.array([p.strip() != NEGATIVE_PREDICTION for p in preds],
                         np.int32)


def check_dataset_availability(data_dir: str, verbose: bool = True) -> bool:
    required = [
        os.path.join(data_dir, "stage2_train_metadata.csv"),
        os.path.join(data_dir, "stage2_test_metadata.csv"),
        os.path.join(data_dir, "Training", "Images"),
        os.path.join(data_dir, "Test"),
    ]
    if not all(os.path.exists(p) for p in required):
        if verbose:
            print(f"Dataset not found in {data_dir} with expected structure.")
            print("Required: stage2_train_metadata.csv, "
                  "stage2_test_metadata.csv, Training/Images/, Test/")
            print("Run `python src/download_dataset.py` first if needed.")
        return False
    train_pngs = [f for f in os.listdir(required[2]) if f.endswith(".png")]
    test_pngs = [f for f in os.listdir(required[3]) if f.endswith(".png")]
    if not train_pngs or not test_pngs:
        if verbose:
            print("No images found in Training/Images/ or Test/.")
        return False
    if verbose:
        print(f"Dataset found: {len(train_pngs)} training images, "
              f"{len(test_pngs)} test images.")
    return True


def train_paths(data_dir: str, ids: list[str]) -> list[str]:
    base = os.path.join(data_dir, "Training", "Images")
    return [os.path.join(base, f"{pid}.png") for pid in ids]


def test_paths(data_dir: str, ids: list[str]) -> list[str]:
    base = os.path.join(data_dir, "Test")
    return [os.path.join(base, f"{pid}.png") for pid in ids]
