"""Exact 3-D nearest neighbour (PyTorch wrapper of ``csrc/nn_search.cu``;
counterpart of ``pointdsc_tpu/kernels/nn_search.py``).

For every query point, the squared distance and index of its nearest base
point, d2 = (|q|^2 + |b|^2) - 2 q.b in float32 and not clamped, as the TPU
kernel computes it. Masked base points carry |b|^2 = 1e30 and never win; ties
go to the lowest base index; a query whose base points are all masked gets
index 0 and d2 = 1e30. The kernel streams base tiles through shared memory,
so nothing [N, M] exists; on a CPU tensor the wrapper runs its plain
version, which forms the [N, M] matrix.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda

_BIG = 1e30
MAX_BASE = 1 << 24  # the TPU kernel carries the index in f32: exact below 2^24


def pack_points(pts: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """[..., N, 4] f32: x, y, z, |p|^2 (1e30 where ``mask`` is False)."""
    pts = pts.float()
    sq = torch.sum(pts * pts, dim=-1, keepdim=True)
    if mask is not None:
        sq = torch.where(mask[..., None], sq, torch.full_like(sq, _BIG))
    return torch.cat([pts, sq], dim=-1).contiguous()


def nearest_neighbors_plain(qp: torch.Tensor, bp: torch.Tensor):
    """Plain version on packed [B, N, 4] / [B, M, 4]: the [B, N, M] matrix
    with the kernel's operations in its order (the 3-term dot product written
    out elementwise, so nothing is contracted), then the first minimum; a row
    with nothing below 1e30 gets (1e30, 0), as the kernel's running minimum."""
    inner = (qp[..., :, None, 0] * bp[..., None, :, 0] + qp[..., :, None, 1] * bp[..., None, :, 1]) \
        + qp[..., :, None, 2] * bp[..., None, :, 2]
    d2 = (qp[..., :, None, 3] + bp[..., None, :, 3]) - 2.0 * inner
    dmin, idx = torch.min(d2, dim=-1)
    found = dmin < _BIG
    return (torch.where(found, dmin, torch.full_like(dmin, _BIG)),
            torch.where(found, idx, torch.zeros_like(idx)))


def _launch_nn(qp: torch.Tensor, bp: torch.Tensor):
    b, n, _ = qp.shape
    m = bp.shape[1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=qp.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=qp.device)
    _build.launch("nn_search", "nearest_neighbors", qp.device, qp.data_ptr(), bp.data_ptr(),
                  d2.data_ptr(), idx.data_ptr(), b, n, m)
    return d2, idx.long()


def nearest_neighbors(query: torch.Tensor, base: torch.Tensor,
                      base_mask: torch.Tensor | None = None):
    """(d2 [..., N] f32, idx [..., N] int64) of each query point's nearest
    base point. query [N, 3] or [B, N, 3], base [M, 3] or [B, M, 3],
    base_mask [M] / [B, M] bool or None (masked points are never chosen).
    A batch runs in one launch. Refuses M >= 2^24, as the TPU kernel does."""
    if base.shape[-2] >= MAX_BASE:
        raise ValueError(
            f"nearest_neighbors: base cloud has {base.shape[-2]} points; the kernel's "
            "index is exact only below 2^24 (the TPU kernel's f32 carry). Split the base cloud.")
    expect(query, "query", dtype=torch.float32, last=3)
    expect(base, "base", dtype=torch.float32, ndim=query.ndim, last=3, device=query.device)
    if query.ndim not in (2, 3) or query.shape[:-2] != base.shape[:-2]:
        raise ValueError(f"query {tuple(query.shape)} and base {tuple(base.shape)}: expected "
                         "[N, 3] and [M, 3], or [B, N, 3] and [B, M, 3]")
    if base_mask is not None:
        expect(base_mask, "base_mask", dtype=torch.bool, shape=base.shape[:-1],
               device=query.device)
    single = query.ndim == 2
    qp, bp = pack_points(query), pack_points(base, base_mask)
    if single:
        qp, bp = qp[None], bp[None]
    if not on_cuda(qp):
        d2, idx = nearest_neighbors_plain(qp, bp)
    else:
        nearest_neighbors.launches += 1
        d2, idx = _launch_nn(qp, bp)
    return (d2[0], idx[0]) if single else (d2, idx)


nearest_neighbors.launches = 0
