"""Numpy SE(3) helpers for the host data pipeline (the port's own copy of
``pointdsc_tpu/data/transforms_np.py``)."""

from __future__ import annotations

import numpy as np


def transform(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    return pts @ trans[:3, :3].T + trans[:3, 3]


def integrate_trans(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    trans = np.eye(4)
    trans[:3, :3] = R
    trans[:3, 3] = np.reshape(t, 3)
    return trans


def rotation_matrix(num_axis: int, magnitude: float, rng: np.random.Generator):
    """Random augmentation rotation (reference utils/SE3.py:5-30)."""
    if num_axis == 0:
        return np.eye(3)
    angles = rng.random(3) * 2.0 * np.pi * magnitude
    c, s = np.cos(angles), np.sin(angles)
    Rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    Ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    Rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    if num_axis == 1:
        return (Rx, Ry, Rz)[rng.integers(0, 3)]
    return Rx @ Ry @ Rz


def translation_matrix(magnitude: float, rng: np.random.Generator):
    return rng.random(3) * magnitude

