"""Spatial-consistency matrix for the dense path (PyTorch counterpart of
``pointdsc_tpu/ops/compatibility.py:18-50``)."""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.ops.knn import pairwise_dists_exact


def spatial_consistency(
    src_keypts: torch.Tensor,
    tgt_keypts: torch.Tensor,
    sigma_d: float,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(compat, src_dist): compat = clamp(1 - (d_src - d_tgt)^2 / sigma_d^2, 0)
    over [..., N, N] with invalid rows and columns zeroed, and the src
    distances the dense NMS reuses (the JAX function's
    ``return_src_dist=True``). Distances use the difference form: the gram
    expansion loses ~1e-4 to cancellation, amplified by 1/sigma_d^2."""
    src_dist = pairwise_dists_exact(src_keypts)
    tgt_dist = pairwise_dists_exact(tgt_keypts)
    diff = src_dist - tgt_dist
    compat = torch.clamp(1.0 - diff * diff / (sigma_d * sigma_d), min=0.0)
    if mask is not None:
        pair_mask = mask[..., :, None] & mask[..., None, :]
        compat = torch.where(pair_mask, compat, torch.zeros_like(compat))
    return compat, src_dist
