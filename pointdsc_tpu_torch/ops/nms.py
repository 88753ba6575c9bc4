"""Seed selection by matrix-parallel NMS, the dense oracle (PyTorch
counterpart of ``pointdsc_tpu/ops/nms.py:17-58``)."""

from __future__ import annotations

import torch

_NEG = -1e9


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose order is IEEE total order on float32: -0.0 sorts
    below +0.0, as ``jax.lax.top_k`` orders them (torch's float comparison
    treats them as equal)."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_k_like_jax(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, in the order
    ``jax.lax.top_k`` returns them: descending, +0.0 before -0.0, and ties
    broken by the lower index (a stable descending sort; ``torch.topk``
    promises no order on ties)."""
    order = torch.sort(_total_order_key(key.float()), dim=-1, descending=True,
                       stable=True).indices
    return order[..., :k]


def nms_key(scores: torch.Tensor, is_local_max: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    """score * flag, so a suppressed point's key is +-0.0 by the sign of its
    score (the reference's quirk: suppressed points can outrank local maxima
    with negative scores); invalid points get -inf."""
    key = scores * is_local_max
    if mask is not None:
        key = torch.where(mask, key, torch.full_like(key, -float("inf")))
    return key


def pick_seeds_nms(
    dists: torch.Tensor,
    scores: torch.Tensor,
    radius: float,
    max_num: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """i is a local max iff for every j: score[i] >= score[j] or
    dist(i, j) >= radius. Seeds are the top ``max_num`` by score * flag.
    Invalid points never suppress valid ones and sort last.
    dists [..., N, N], scores [..., N] -> [..., max_num] int64."""
    if mask is not None:
        dists = torch.where(mask[..., None, :], dists, torch.full_like(dists, float("inf")))
        scores_cmp = torch.where(mask, scores, torch.full_like(scores, _NEG))
    else:
        scores_cmp = scores
    score_relation = scores_cmp[..., :, None] >= scores_cmp[..., None, :]
    free = score_relation | (dists >= radius)
    is_local_max = torch.amin(free.to(scores.dtype), dim=-1)
    return top_k_like_jax(nms_key(scores, is_local_max, mask), max_num)
