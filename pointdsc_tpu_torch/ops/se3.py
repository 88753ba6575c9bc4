"""SE(3) rigid-transform utilities (batched; PyTorch counterpart of
``pointdsc_tpu/ops/se3.py``). All functions broadcast over leading dims."""

from __future__ import annotations

import torch


def transform(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """out = R @ p + t for pts [..., N, 3] and trans [..., 4, 4]."""
    R = trans[..., :3, :3]
    t = trans[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def integrate_trans(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] SE(3) matrices from R [..., 3, 3] and t
    ([..., 3], [..., 3, 1] or [..., 1, 3])."""
    t = t.reshape(R.shape[:-2] + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)  # [..., 3, 4]
    bottom = R.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
