"""Point-to-point ICP and the registration information matrix (PyTorch
counterpart of ``pointdsc_tpu/ops/icp.py``).

Both find, for every warped source point, its nearest target point through
``kernels/nn_search.py::nearest_neighbors``: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor. The JAX package takes its TPU
kernel only when N * M >= 64M (a crossover measured on a TPU v5e) and the
dense [N, M] form below that; the card's crossover is not measured yet
(``chip_smoke.py`` times both), so here the kernel runs at every size. The
kernel's d2 is not clamped; it is clamped at 0 here, as the JAX dense
branch's ``pairwise_sq_dists`` clamps it, so that coincident points can
never give a negative residual. A leading batch axis runs every pair's
search of one iteration in one launch; the loop never reads a value back
to the host.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels.nn_search import nearest_neighbors
from pointdsc_tpu_torch.ops.procrustes import weighted_procrustes
from pointdsc_tpu_torch.ops.se3 import transform


def _ones_mask(pts: torch.Tensor) -> torch.Tensor:
    return torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)


def _gather(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts[..., idx, :] for pts [..., M, 3] and idx [..., N]."""
    return torch.gather(pts, -2, idx[..., None].expand(idx.shape + (3,)))


def _nearest(warped, tgt_pts, tgt_mask):
    d2, idx = nearest_neighbors(warped, tgt_pts, tgt_mask)
    return torch.clamp(d2, min=0.0), idx


def icp_point_to_point(src_pts: torch.Tensor, tgt_pts: torch.Tensor, init_trans: torch.Tensor,
                       max_correspondence_distance: float = 0.10, max_iters: int = 20,
                       src_mask: torch.Tensor | None = None,
                       tgt_mask: torch.Tensor | None = None):
    """ICP refinement of init_trans [..., 4, 4] for src [..., N, 3] onto tgt
    [..., M, 3]. Returns (trans [..., 4, 4], fitness [...], inlier_rmse [...]).

    ``max_iters`` fixed iterations; a pair with fewer than 3 matches keeps its
    transform. fitness (matched share of the valid source points) and rmse
    (over the matched pairs) come from the last iteration's search, i.e.
    against the transform before the last update, as Open3D's result and
    the JAX scan report them."""
    src_mask = _ones_mask(src_pts) if src_mask is None else src_mask
    tgt_mask = _ones_mask(tgt_pts) if tgt_mask is None else tgt_mask
    max_d2 = max_correspondence_distance ** 2
    trans = init_trans
    for _ in range(max_iters):
        nn_d2, nn_idx = _nearest(transform(src_pts, trans).contiguous(), tgt_pts, tgt_mask)
        matched = (nn_d2 < max_d2) & src_mask
        w = matched.to(src_pts.dtype)
        new_trans = weighted_procrustes(src_pts, _gather(tgt_pts, nn_idx), w)
        enough = torch.sum(w, dim=-1) >= 3  # freeze a degenerate pair
        trans = torch.where(enough[..., None, None], new_trans, trans)

    num_valid = torch.clamp(torch.sum(src_mask, dim=-1), min=1)
    num_matched = torch.sum(matched, dim=-1)
    fitness = num_matched / num_valid
    rmse = torch.sqrt(torch.sum(torch.where(matched, nn_d2, torch.zeros_like(nn_d2)), dim=-1)
                      / torch.clamp(num_matched, min=1))
    return trans, fitness, rmse


def information_matrix(src_pts: torch.Tensor, tgt_pts: torch.Tensor, trans: torch.Tensor,
                       max_correspondence_distance: float = 0.10,
                       src_mask: torch.Tensor | None = None,
                       tgt_mask: torch.Tensor | None = None) -> torch.Tensor:
    """6x6 registration information matrix [..., 6, 6] (Open3D semantics):
    the sum of G^T G over the source points whose warped position has a
    target neighbour within the threshold, with G = [skew(q) | I] at the
    *target* point q and parameters (rx, ry, rz, tx, ty, tz). info[5, 5] is
    the correspondence count."""
    src_mask = _ones_mask(src_pts) if src_mask is None else src_mask
    tgt_mask = _ones_mask(tgt_pts) if tgt_mask is None else tgt_mask
    nn_d2, nn_idx = _nearest(transform(src_pts, trans).contiguous(), tgt_pts, tgt_mask)
    matched = (nn_d2 < max_correspondence_distance ** 2) & src_mask
    w = matched.to(src_pts.dtype)

    q = _gather(tgt_pts, nn_idx)
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    G = torch.stack([
        torch.stack([zeros, z, -y, ones, zeros, zeros], dim=-1),
        torch.stack([-z, zeros, x, zeros, ones, zeros], dim=-1),
        torch.stack([y, -x, zeros, zeros, zeros, ones], dim=-1),
    ], dim=-2)  # [..., N, 3, 6]
    return torch.einsum("...nij,...nik,...n->...jk", G, G, w)
