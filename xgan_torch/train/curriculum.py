"""Curriculum schedule parsing/lookup (copy of xgan/train/curriculum.py;
reference train_classifier.py:27-63).

Schedule strings look like "0:0.0, 5:0.25, 10:0.5" — epoch:ratio pairs.
Epoch 0 is implicitly ratio 0.0 when absent. The active ratio at epoch e is
the value at the largest schedule epoch <= e.
"""
from __future__ import annotations

from typing import Dict


def parse_curriculum_schedule(schedule_str: str) -> Dict[int, float]:
    schedule: Dict[int, float] = {}
    if not schedule_str:
        return schedule
    try:
        for part in schedule_str.split(","):
            epoch_str, ratio_str = part.strip().split(":")
            epoch, ratio = int(epoch_str), float(ratio_str)
            if epoch < 0:
                raise ValueError(f"Epoch must be non-negative: {epoch}")
            if not 0.0 <= ratio <= 1.0:
                raise ValueError(
                    f"Ratio must be between 0.0 and 1.0: {ratio}")
            schedule[epoch] = ratio
        if 0 not in schedule:
            schedule[0] = 0.0
        return dict(sorted(schedule.items()))
    except Exception as e:
        raise ValueError(
            f"Invalid curriculum schedule format: '{schedule_str}'. "
            f"Error: {e}. Expected format: 'epoch1:ratio1, epoch2:ratio2,...'")


def get_current_synthetic_ratio(epoch: int,
                                schedule: Dict[int, float]) -> float:
    if not schedule:
        return 0.0
    applicable = [e for e in schedule if e <= epoch]
    if applicable:
        return schedule[max(applicable)]
    return schedule.get(0, 0.0)
