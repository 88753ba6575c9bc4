"""Hypothesis scoring: inlier count of every seed transform (PyTorch
wrapper of ``csrc/scoring.cu``; counterpart of
``pointdsc_tpu/kernels/scoring.py:27-171``).

Only the [B, S] counts leave the kernel; the best seed's per-point labels
are recomputed for that one transform by the caller. On a CPU tensor the
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda


def pack_scoring_points(src, tgt, mask=None):
    """[B, 8, N] f32: rows 0-2 src xyz, 3 ones, 4-6 tgt xyz, 7 mask."""
    b, n, _ = src.shape
    pts = torch.ones((b, 8, n), dtype=torch.float32, device=src.device)
    pts[:, 0:3] = src.float().transpose(1, 2)
    pts[:, 4:7] = tgt.float().transpose(1, 2)
    if mask is not None:
        pts[:, 7] = mask.float()
    return pts


def pack_scoring_trans(trans):
    """[B, S, 4, 4] -> [B, S, 16]: cols 4i..4i+3 = (R[i, :], t[i]), 12-15 zeros."""
    out = torch.zeros(trans.shape[:-2] + (16,), dtype=torch.float32, device=trans.device)
    out[..., :12] = trans[..., :3, :].float().reshape(trans.shape[:-2] + (12,))
    return out


def thr_sq(thr: float) -> float:
    t = np.float32(thr)
    return float(t * t)


def seed_inlier_counts_plain(tr, pts, thr2):
    """Plain version: pred_i = R_i . x + t_i, d2 < thr^2, masked sum."""
    x = pts[:, None, 0:4, :]  # [B, 1, 4, N] homogeneous src
    d2 = 0.0
    for i in range(3):
        row = tr[:, :, 4 * i:4 * i + 4, None]  # [B, S, 4, 1]
        pred = (row[:, :, 0] * x[:, :, 0] + row[:, :, 1] * x[:, :, 1]
                + row[:, :, 2] * x[:, :, 2] + row[:, :, 3])
        d2 = d2 + (pred - pts[:, None, 4 + i]) ** 2
    inl = (d2 < torch.tensor(thr2, device=pts.device)).float() * pts[:, None, 7]
    return torch.sum(inl, dim=-1)


def _launch_scoring(tr, pts, thr2):
    b, s, _ = tr.shape
    n = pts.shape[-1]
    counts = torch.empty((b, s), dtype=torch.float32, device=tr.device)
    _build.launch("scoring", "seed_inlier_counts", tr.device, tr.data_ptr(), pts.data_ptr(),
                  counts.data_ptr(), b, s, n, thr2)
    return counts


def seed_inlier_counts(seed_trans, src_keypts, tgt_keypts, thr, mask=None):
    """Inlier count of every seed transform over all correspondences.
    seed_trans [B, S, 4, 4], src/tgt [B, N, 3], mask [B, N] -> [B, S] f32."""
    expect(seed_trans, "seed_trans", ndim=4, last=4)
    b, s = seed_trans.shape[:2]
    expect(seed_trans, "seed_trans", shape=(b, s, 4, 4))
    expect(src_keypts, "src_keypts", ndim=3, last=3, device=seed_trans.device)
    expect(tgt_keypts, "tgt_keypts", shape=src_keypts.shape, device=seed_trans.device)
    if src_keypts.shape[0] != b:
        raise ValueError(f"seed_trans has batch {b}, src_keypts {src_keypts.shape[0]}")
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src_keypts.shape[:2],
               device=seed_trans.device)
    tr = pack_scoring_trans(seed_trans)
    pts = pack_scoring_points(src_keypts, tgt_keypts, mask)
    t2 = thr_sq(thr)
    if not on_cuda(tr):
        return seed_inlier_counts_plain(tr, pts, t2)
    seed_inlier_counts.launches += 1
    return _launch_scoring(tr, pts, t2)


seed_inlier_counts.launches = 0
