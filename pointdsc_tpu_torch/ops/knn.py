"""Pairwise distances (PyTorch counterpart of ``pointdsc_tpu/ops/knn.py``)
and the NSM's seed k-NN outside the JAX model's kernel gate; the kernel's is
``kernels/seed_knn.py``."""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.ops.linalg import sqrt_rn


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


def pairwise_dists_exact(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Euclidean distances [..., N, M] from x [..., N, C] to y [..., M, C]
    (y = x when None) in the difference form sqrt(sum((x_i - y_j)^2)):
    exact for low-dimensional points, where the gram expansion loses ~1e-4
    to cancellation. The coordinates are summed in order, one [..., N, M]
    term at a time (the order XLA uses, and no [..., N, M, C] tensor)."""
    if y is None:
        y = x
    sq = 0.0
    for c in range(x.shape[-1]):
        d = x[..., :, None, c] - y[..., None, :, c]
        sq = sq + d * d
    # torch's vectorised CPU sqrt can be 1 ulp off, which 1/sigma_d^2 turns
    # into ~5e-6 of compat
    return sqrt_rn(sq)



def seed_knn_sorted(features: torch.Tensor, seeds: torch.Tensor, k: int,
                    mask: torch.Tensor) -> torch.Tensor:
    """[B, S, k] int64: the JAX model's seed k-NN outside its kernel's gate
    (``pointdsc_tpu/models/pointdsc.py:341-356``). Distances 2 - 2 f.f of the
    L2-normalised features [B, N, C] from the seeds [B, S]; the seed's own
    column and every invalid one (mask [B, N] False) sit at 1e9, one tier, so
    that where fewer than k valid others exist the seed itself and invalid
    points fill the list, the lower index first; the k smallest, ties to the
    lower index."""
    seed_feats = torch.gather(features, 1, seeds[..., None].expand(-1, -1, features.shape[-1]))
    dist = 2.0 - 2.0 * torch.einsum("bsc,bnc->bsn", seed_feats, features)
    cols = torch.arange(features.shape[1], device=features.device)
    far = (cols[None, None, :] == seeds[..., None]) | ~mask[:, None, :]
    dist = torch.where(far, torch.full_like(dist, 1e9), dist)
    return torch.sort(dist, dim=-1, stable=True).indices[..., :k].contiguous()
