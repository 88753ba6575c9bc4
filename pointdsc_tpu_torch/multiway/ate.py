"""Absolute trajectory error (ATE) for multiway registration (PyTorch
counterpart of ``pointdsc_tpu/multiway/ate.py``).

The estimated camera-center trajectory is aligned to the ground truth by an
unweighted Procrustes fit, then the RMSE of the aligned positions is
reported in centimeters (reference test_multi_ate.py:31-51,268-290).
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.ops.procrustes import weighted_procrustes
from pointdsc_tpu_torch.ops.se3 import transform


def trajectory_positions(poses: list[np.ndarray]) -> np.ndarray:
    """Fragment poses (node -> world) -> camera centers [n, 3]."""
    return np.stack([np.asarray(p)[:3, 3] for p in poses], axis=0)


@full_f32_matmul()
def align_trajectories(est: np.ndarray, gt: np.ndarray,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """Rigidly align est positions [n, 3] to gt (float32); returns the
    aligned est."""
    dev = resolve_device(device)
    e = torch.as_tensor(np.asarray(est), dtype=torch.float32, device=dev)[None]
    g = torch.as_tensor(np.asarray(gt), dtype=torch.float32, device=dev)[None]
    return transform(e, weighted_procrustes(e, g))[0].cpu().numpy()


def ate_rmse(est_poses: list[np.ndarray], gt_poses: list[np.ndarray],
             device: str | torch.device = "cuda") -> float:
    """ATE RMSE in centimeters after rigid alignment."""
    est = trajectory_positions(est_poses)
    gt = trajectory_positions(gt_poses)
    aligned = align_trajectories(est, gt, device=device)
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))) * 100.0)
