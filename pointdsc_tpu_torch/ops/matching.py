"""Descriptor matching and ground-truth labels (PyTorch counterpart of
``pointdsc_tpu/ops/matching.py``).

One correspondence per source point and a validity mask: a failed mutual
check masks the correspondence instead of dropping it, so shapes stay
fixed.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.ops.se3 import transform


def match_descriptors(src_desc: torch.Tensor, tgt_desc: torch.Tensor, use_mutual: bool = False):
    """Nearest neighbours in descriptor space for L2-normalised src_desc
    [N, C] and tgt_desc [M, C]: the argmax of the inner product (the first
    on ties). Returns (corr [N, 2] int64 (src index, tgt index), mask [N]
    bool); the mask is all True without ``use_mutual``."""
    inner = src_desc @ tgt_desc.T
    src_to_tgt = torch.argmax(inner, dim=1)
    src_ids = torch.arange(src_desc.shape[0], device=src_desc.device)
    corr = torch.stack([src_ids, src_to_tgt], dim=-1)
    if use_mutual:
        tgt_to_src = torch.argmax(inner, dim=0)
        return corr, tgt_to_src[src_to_tgt] == src_ids
    return corr, torch.ones_like(src_ids, dtype=torch.bool)


def inlier_labels(src_keypts: torch.Tensor, tgt_keypts: torch.Tensor, gt_trans: torch.Tensor,
                  inlier_threshold: float) -> torch.Tensor:
    """[..., N] float32 labels: 1 where |T(src) - tgt| < tau
    (reference ThreeDMatch.py:124-129)."""
    dist = torch.linalg.norm(transform(src_keypts, gt_trans) - tgt_keypts, dim=-1)
    return (dist < inlier_threshold).float()
