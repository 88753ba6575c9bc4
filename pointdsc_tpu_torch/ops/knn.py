"""Pairwise distances (PyTorch counterpart of ``pointdsc_tpu/ops/knn.py``).
The seed-restricted k-NN of the NSM is ``kernels/seed_knn.py``."""

from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Squared Euclidean distances [..., N, M] between x [..., N, C] and y
    [..., M, C] in the gram form |x|^2 + |y|^2 - 2 x.y (one matrix product),
    clamped at 0 to absorb the cancellation."""
    if y is None:
        y = x
    inner = x @ y.transpose(-1, -2)
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    return torch.clamp(xx[..., :, None] + yy[..., None, :] - 2.0 * inner, min=0.0)


def pairwise_dists_exact(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [..., N, N] in the difference form
    sqrt(sum((x_i - x_j)^2)): exact for low-dimensional points, where the
    gram expansion loses ~1e-4 to cancellation. The coordinates are summed
    in order, one [..., N, N] term at a time (the order XLA uses, and no
    [..., N, N, C] tensor)."""
    sq = 0.0
    for c in range(x.shape[-1]):
        d = x[..., :, None, c] - x[..., None, :, c]
        sq = sq + d * d
    # torch's vectorised CPU sqrt can be 1 ulp off, which 1/sigma_d^2 turns
    # into ~5e-6 of compat; a float64 sqrt rounded to float32 is the
    # correctly rounded float32 sqrt
    return torch.sqrt(sq.double()).to(sq.dtype)

