"""Numpy SE(3) and augmentation helpers for the host data pipeline (the
port's own copy of ``pointdsc_tpu/data/transforms_np.py``)."""

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



def concatenate(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    return t1 @ t2


def augment_pair(src_keypts: np.ndarray, tgt_keypts: np.ndarray, orig_trans: np.ndarray,
                 num_axis: int, rot_magnitude: float, trans_magnitude: float, jitter: float,
                 rng: np.random.Generator):
    """Jitter both clouds, rotate and translate the target, compose the
    ground truth (reference ThreeDMatch.py:86-94). The generator is drawn in
    the JAX package's order: src jitter, tgt jitter, rotation, translation.
    The clouds come back float64."""
    src_keypts = src_keypts + rng.random(src_keypts.shape) * jitter
    tgt_keypts = tgt_keypts + rng.random(tgt_keypts.shape) * jitter
    aug_R = rotation_matrix(num_axis, rot_magnitude, rng)
    aug_T = translation_matrix(trans_magnitude, rng)
    aug_trans = integrate_trans(aug_R, aug_T)
    tgt_keypts = transform(tgt_keypts, aug_trans)
    gt_trans = concatenate(aug_trans, orig_trans)
    return src_keypts, tgt_keypts, gt_trans
