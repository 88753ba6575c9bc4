"""Redwood/3DMatch registration-evaluation protocol (the port's own copy of
``pointdsc_tpu/eval/redwood_protocol.py``; numpy only).

Rebuilds the reference's evaluation/benchmark_utils_predator.py:56-230:
trajectory (.log) and covariance (.info) parsers, the quaternion-parameter
covariance-weighted transformation error, and scene precision/recall with the
non-consecutive-pair rule (protocol spec: redwood-data.org/indoor/registration).

The reference used nibabel for mat->quat; here the conversion is implemented
directly (Shepperd's method, branch on the largest diagonal element).
"""

from __future__ import annotations

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), numerically stable
    branch on the dominant diagonal term (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def transformation_error(trans: np.ndarray, info: np.ndarray) -> float:
    """Covariance-weighted squared error of a residual transform: the Redwood
    approximation of the RMSE of gt correspondences
    (benchmark_utils_predator.py:56-75). `trans` is the residual
    inv(gt) @ estimate; `info` the 6x6 information matrix."""
    t = trans[:3, 3]
    q = rotation_to_quaternion(trans[:3, :3])
    er = np.concatenate([t, q[1:]], axis=0)
    return float((er.reshape(1, 6) @ info @ er.reshape(6, 1))[0, 0] / info[0, 0])


def read_trajectory(filename: str, dim: int = 4):
    """Parse a Redwood-format trajectory .log: header (i, j, n) + dim x dim
    matrix per block. Returns (keys [n, 3] str array, traj [n, 4, 4])."""
    with open(filename) as f:
        lines = f.readlines()
    keys = []
    mats = []
    i = 0
    while i < len(lines):
        header = lines[i].strip().split()
        keys.append([h.strip() for h in header[:3]])
        block = [
            np.fromstring(lines[i + 1 + r], dtype=float, sep=" \t") for r in range(dim)
        ]
        mats.append(np.stack(block))
        i += dim + 1
    return np.asarray(keys), np.asarray(mats)


def write_trajectory(filename: str, poses, keys=None):
    """Write a Redwood-format trajectory .log (inverse of read_trajectory;
    reference: multiway/fileio.py::write_poses_to_log and
    trajectory.py::write_trajectory). `poses` is a sequence of 4x4; `keys`
    optional per-pose (i, j, n) header tuples, default (k, k, k+1)."""
    n = len(poses)
    # space-separated, matching the reference writers exactly (strict external
    # Redwood tooling splits on single spaces; tabs would break it)
    with open(filename, "w") as f:
        for k in range(n):
            i, j, m = keys[k] if keys is not None else (k, k, k + 1)
            f.write(f"{i} {j} {m}\n")
            for row in np.asarray(poses[k], dtype=float).reshape(4, 4):
                f.write(" ".join(f"{v:.12f}" for v in row) + "\n")


def read_trajectory_info(filename: str, dim: int = 6):
    """Parse a .info file: header (i, j, n) + 6x6 covariance per block.
    Returns (num_fragments, cov [n, 6, 6])."""
    with open(filename) as f:
        lines = f.readlines()
    n_pairs = len(lines) // 7
    assert len(lines) == 7 * n_pairs, "malformed .info file"
    infos = []
    n_frame = 0
    for i in range(n_pairs):
        _, _, n_frame = (int(v) for v in lines[i * 7].strip().split())
        block = [
            np.fromstring(lines[i * 7 + 1 + r], sep="\t").reshape(-1) for r in range(dim)
        ]
        infos.append(np.stack(block))
    return n_frame, np.asarray(infos)


def evaluate_registration(
    num_fragment: int,
    result: np.ndarray,
    result_pairs: np.ndarray,
    gt_pairs: np.ndarray,
    gt: np.ndarray,
    gt_info: np.ndarray,
    err2: float = 0.2,
):
    """Scene registration precision/recall under the Redwood protocol
    (benchmark_utils_predator.py:174-230): only non-consecutive gt pairs
    count; success iff covariance-weighted RMSE <= err2 (meters).

    Returns (precision, recall, flags) where flags[i] in {0 good, 1 bad,
    2 not-in-gt}.
    """
    err2 = err2**2
    gt_index = np.zeros((num_fragment, num_fragment), dtype=int)
    for idx in range(gt_pairs.shape[0]):
        i, j = int(gt_pairs[idx, 0]), int(gt_pairs[idx, 1])
        if j - i > 1:  # only non-consecutive pairs are tested
            gt_index[i, j] = idx
    n_gt = int(np.sum(gt_index > 0))

    good, n_res = 0, 0
    flags = []
    for idx in range(result_pairs.shape[0]):
        i, j = int(result_pairs[idx, 0]), int(result_pairs[idx, 1])
        if gt_index[i, j] > 0:
            n_res += 1
            gt_idx = gt_index[i, j]
            residual = np.linalg.inv(gt[gt_idx]) @ result[idx]
            if transformation_error(residual, gt_info[gt_idx]) <= err2:
                good += 1
                flags.append(0)
            else:
                flags.append(1)
        else:
            flags.append(2)
    precision = good / n_res if n_res else 0.0
    recall = good / n_gt if n_gt else 0.0
    return precision, recall, flags
