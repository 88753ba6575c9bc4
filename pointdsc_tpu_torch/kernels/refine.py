"""Post-refinement of the winning hypothesis (PyTorch wrapper of
``csrc/refine.cu``; counterpart of ``pointdsc_tpu/kernels/refine.py``).

Up to ``max_iters`` rounds of {warp, inliers, Geman-McClure re-fit}; a
sample freezes once its inlier count stops changing. Each round needs only
the sums of the Gram form (w s t^T, w s, w t, w and the inlier count), so
both clouds are first centred on their masked means: the uncentred second
moments then cancel over the cloud's extent, not its distance from the
origin (KITTI clouds sit ~100 m out). The kernel runs the whole function
(the means, the centring, both frame shifts and every round of every
sample) in one launch; on a CPU tensor the wrapper runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda
from pointdsc_tpu_torch.ops.procrustes import rotation_from_covariance
from pointdsc_tpu_torch.ops.se3 import integrate_trans


def pack_refine_strip(src, tgt, mask):
    """[B, 8, N] f32: rows 0-2 src xyz, 3 mask, 4-6 tgt xyz, 7 zeros."""
    b, n, _ = src.shape
    strip = torch.zeros((b, 8, n), dtype=torch.float32, device=src.device)
    strip[:, 0:3] = src.transpose(1, 2)
    strip[:, 3] = mask.float()
    strip[:, 4:7] = tgt.transpose(1, 2)
    return strip


def _shift(trans, a_src, a_tgt, sign):
    """Re-express trans between the original and the centred frame:
    t' = (t + sign R a_src) - sign a_tgt, summed in the JAX package's order."""
    R = trans[:, :3, :3]
    t = (trans[:, :3, 3] + sign * torch.einsum("bij,bj->bi", R, a_src)) - sign * a_tgt
    return integrate_trans(R, t)


def refine_sums(strip, trans, thr):
    """Per sample [B, 17]: sum w s t^T (9, row-major), w s (3), w t (3), w,
    inlier count; w = inl / (1 + d2 / thr^2) at the current trans."""
    s, m, t = strip[:, 0:3], strip[:, 3], strip[:, 4:7]
    thr2 = torch.tensor(np.float32(thr) * np.float32(thr), device=strip.device)
    warped = torch.einsum("bij,bjn->bin", trans[:, :3, :3], s) + trans[:, :3, 3, None]
    d2 = torch.sum((warped - t) ** 2, dim=1)
    inl = (d2 < thr2).float() * m
    w = inl / (1.0 + d2 / thr2)
    ws = w[:, None] * s
    return torch.cat([torch.einsum("bin,bjn->bij", ws, t).reshape(-1, 9), ws.sum(-1),
                      (w[:, None] * t).sum(-1), w.sum(-1, keepdim=True),
                      inl.sum(-1, keepdim=True)], dim=-1)


def procrustes_from_sums(g):
    """Horn fit [B, 4, 4] from the sums of ``refine_sums``."""
    wsum = g[:, 15] + 1e-6
    cs = g[:, 9:12] / wsum[:, None]
    ct = g[:, 12:15] / wsum[:, None]
    H = g[:, :9].reshape(-1, 3, 3) - wsum[:, None, None] * (cs[:, :, None] * ct[:, None, :])
    R = rotation_from_covariance(H)
    return integrate_trans(R, ct - torch.einsum("bij,bj->bi", R, cs))


def refine_plain(strip, trans0, thr, max_iters):
    """Plain version of the kernel's loop (centred frame): every round runs,
    a frozen sample stays frozen, which is the early-exit loop's result.
    Returns the transforms and the rounds each sample ran, [B] int32, counted
    as the kernel counts them: the rounds in which it was active, the one
    that saw no change included."""
    trans = trans0
    prev = torch.zeros(trans.shape[0], dtype=torch.float32, device=trans.device)
    active = torch.ones(trans.shape[0], dtype=torch.bool, device=trans.device)
    rounds = torch.zeros(trans.shape[0], dtype=torch.int32, device=trans.device)
    for _ in range(max_iters):
        rounds += active.int()
        g = refine_sums(strip, trans, thr)
        num = g[:, 16]
        active = active & (torch.abs(num - prev) >= 1)
        trans = torch.where(active[:, None, None], procrustes_from_sums(g), trans)
        prev = num
    return trans, rounds


def _centre(initial_trans, src_keypts, tgt_keypts, mask):
    """The strip of both clouds centred on their masked means, the initial
    transform in that frame, and the two means."""
    m = mask[..., None].float()
    count = torch.clamp(torch.sum(m, dim=1), min=1.0)
    a_src = torch.sum(src_keypts * m, dim=1) / count
    a_tgt = torch.sum(tgt_keypts * m, dim=1) / count
    strip = pack_refine_strip(src_keypts - a_src[:, None], tgt_keypts - a_tgt[:, None], mask)
    return strip, _shift(initial_trans, a_src, a_tgt, 1.0), a_src, a_tgt


def fused_post_refinement_plain(initial_trans, src_keypts, tgt_keypts, mask, thr, max_iters,
                                return_iters=False):
    """Plain version of the wrapper on any device; with ``return_iters`` also
    the rounds of ``refine_plain``."""
    strip, trans0, a_src, a_tgt = _centre(initial_trans, src_keypts, tgt_keypts, mask)
    trans, rounds = refine_plain(strip, trans0, thr, max_iters)
    trans = _shift(trans, a_src, a_tgt, -1.0)
    return (trans, rounds) if return_iters else trans


def fused_post_refinement(initial_trans, src_keypts, tgt_keypts, mask, thr, max_iters,
                          return_iters=False):
    """Refined [B, 4, 4] from initial_trans [B, 4, 4], src/tgt [B, N, 3]
    and mask [B, N] bool. With ``return_iters`` also the rounds each sample
    ran, [B] int32 (the kernel's count on the card, the plain loop's on the
    CPU)."""
    expect(initial_trans, "initial_trans", dtype=torch.float32, ndim=3)
    b = initial_trans.shape[0]
    expect(initial_trans, "initial_trans", shape=(b, 4, 4))
    expect(src_keypts, "src_keypts", dtype=torch.float32, ndim=3, last=3,
           device=initial_trans.device)
    expect(tgt_keypts, "tgt_keypts", dtype=torch.float32, shape=src_keypts.shape,
           device=initial_trans.device)
    expect(mask, "mask", dtype=torch.bool, shape=src_keypts.shape[:2],
           device=initial_trans.device)
    if src_keypts.shape[0] != b:
        raise ValueError(f"initial_trans has batch {b}, src_keypts {src_keypts.shape[0]}")
    if not on_cuda(initial_trans):
        return fused_post_refinement_plain(initial_trans, src_keypts, tgt_keypts, mask, thr,
                                           max_iters, return_iters=return_iters)
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=initial_trans.device)
    iters = torch.empty((b,), dtype=torch.int32, device=initial_trans.device)
    fused_post_refinement.launches += 1
    _build.launch("refine", "fused_post_refinement", initial_trans.device,
                  initial_trans.data_ptr(), src_keypts.data_ptr(), tgt_keypts.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), iters.data_ptr(), b, src_keypts.shape[1],
                  float(np.float32(thr)), max_iters)
    return (out, iters) if return_iters else out


fused_post_refinement.launches = 0
