"""Auxiliary evaluation metrics (reference evaluation/benchmark_utils.py); the
port's copy of ``pointdsc_tpu/eval/metrics.py``, numpy only.

exact_auc: area under the cumulative error curve at given thresholds
(benchmark_utils.py:9-24). rot_to_euler: xyz Euler angles in degrees
(benchmark_utils.py:74-95).
"""

from __future__ import annotations

import numpy as np


def exact_auc(errors: np.ndarray, thresholds) -> list[float]:
    """AUC of the recall-vs-error curve, exactly integrated up to each
    threshold and normalized by it."""
    errors = np.sort(np.asarray(errors, dtype=np.float64))
    n = len(errors)
    recall = (np.arange(n) + 1) / n
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last], [recall[max(last - 1, 0)]]])
        e = np.concatenate([errors[:last], [t]])
        aucs.append(float(np.trapezoid(r, x=e) / t))
    return aucs


def rot_to_euler(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> xyz Euler angles in degrees (ZYX intrinsic
    convention with gimbal-lock fallback)."""
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy > 1e-6:
        x = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(-R[2, 0], sy)
        z = np.arctan2(R[1, 0], R[0, 0])
    else:
        x = np.arctan2(-R[1, 2], R[1, 1])
        y = np.arctan2(-R[2, 0], sy)
        z = 0.0
    return np.degrees(np.array([x, y, z]))
