"""Seed NMS from coordinates, tile-wise (PyTorch wrapper of
``csrc/nms.cu``; counterpart of ``pointdsc_tpu/kernels/nms.py:26-214``).

    is_local_max[i] = all_j ( score[i] >= score[j]  or  d2(i, j) >= R^2 )

The kernel computes the flags without an [N, N] distance matrix; the top-k
over score * flag stays in PyTorch, ordered as ``jax.lax.top_k`` orders it
(ops/nms.py::top_k_like_jax). On a CPU tensor ``nms_local_max`` runs its
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda
from pointdsc_tpu_torch.ops.nms import nms_key, top_k_like_jax

_NEG = -1e9


def pack_nms_geometry(src: torch.Tensor, scores: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 8, N] strip: rows 0-2 src xyz, 3 |src|^2, 4 scores (invalid
    entries at -1e9 so they never suppress), 5-7 zeros."""
    b, n, _ = src.shape
    src = src.float()
    geom = torch.zeros((b, 8, n), dtype=torch.float32, device=src.device)
    geom[:, 0:3] = src.transpose(1, 2)
    geom[:, 3] = torch.sum(src * src, dim=-1)
    s = scores.float()
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    geom[:, 4] = s
    return geom


def radius_sq(radius: float) -> float:
    """R^2 evaluated in float32, as the TPU kernel does."""
    r = np.float32(radius)
    return float(r * r)


def nms_local_max_plain(geom: torch.Tensor, r2: float) -> torch.Tensor:
    """Plain version of the flag kernel: gram-form d2, AND over keys."""
    xyz = geom[:, 0:3]
    inner = xyz.transpose(1, 2) @ xyz
    d2 = torch.clamp(geom[:, 3, :, None] + geom[:, 3, None, :] - 2.0 * inner, min=0.0)
    s = geom[:, 4]
    free = (s[:, :, None] >= s[:, None, :]) | (d2 >= torch.tensor(r2, device=geom.device))
    return torch.all(free, dim=-1).float()


def _launch_nms(geom: torch.Tensor, r2: float) -> torch.Tensor:
    b, _, n = geom.shape
    flags = torch.empty((b, n), dtype=torch.float32, device=geom.device)
    _build.launch("nms", "nms_local_max", geom.device, geom.data_ptr(), flags.data_ptr(),
                  b, n, r2)
    return flags


def nms_local_max(src, scores, radius, mask=None):
    """Local-max flags [B, N] (f32 in {0, 1}) from src [B, N, 3] and
    scores [B, N]."""
    expect(src, "src", ndim=3, last=3)
    expect(scores, "scores", shape=src.shape[:2], device=src.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=src.device)
    geom = pack_nms_geometry(src, scores, mask)
    r2 = radius_sq(radius)
    if not on_cuda(geom):
        return nms_local_max_plain(geom, r2)
    nms_local_max.launches += 1
    return _launch_nms(geom, r2)


nms_local_max.launches = 0


def pick_seeds_nms_fused(src, scores, radius, max_num, mask=None):
    """Same selection as ops.nms.pick_seeds_nms, from coordinates."""
    flags = nms_local_max(src, scores, radius, mask=mask)
    return top_k_like_jax(nms_key(scores, flags, mask), max_num)


def pick_seeds_nms_prefiltered(src, scores, radius, max_num, mask=None, prefilter=None):
    """Exact NMS seed picking through a top-M score prefilter (large N).

    Any suppressor of a top-M point has a strictly higher score, so it is in
    the top-M set too, and flags computed within that subset are exact for
    its members. The subset's selection equals the full one whenever the
    max_num-th selected key strictly exceeds max(tau_M, 0), tau_M being the
    M-th score (the certificate); otherwise the full kernel runs. A
    positivity precheck skips the subset when the certificate cannot pass.
    Precheck and certificate are host branches: each forces one device sync.
    """
    n = src.shape[-2]
    if prefilter is None:
        prefilter = max(4 * max_num, 4096)
    # the same rounding as the JAX entry: a 1024 multiple, at least max_num
    m = -(-max(prefilter, max_num) // 1024) * 1024
    if 2 * m > n:
        # the prefilter pays only when it prunes most of the pair grid
        return pick_seeds_nms_fused(src, scores, radius, max_num, mask=mask)
    msk = mask if mask is not None else torch.ones(scores.shape, dtype=torch.bool,
                                                   device=scores.device)
    ranked = torch.where(msk, scores, torch.full_like(scores, -float("inf")))
    idx_m = top_k_like_jax(ranked, m)  # [B, M]
    vals_m = torch.gather(ranked, 1, idx_m)

    # host sync 1: the certificate needs max_num strictly positive keys
    if not bool(torch.all(vals_m[:, max_num - 1] > 0.0)):
        return pick_seeds_nms_fused(src, scores, radius, max_num, mask=mask)

    sub_src = torch.gather(src, 1, idx_m[..., None].expand(-1, -1, 3)).contiguous()
    sub_scores = torch.gather(scores, 1, idx_m)
    sub_mask = torch.gather(msk, 1, idx_m) if mask is not None else None
    flags = nms_local_max(sub_src, sub_scores, radius, mask=sub_mask)
    key_m = nms_key(sub_scores, flags, sub_mask)
    kidx = top_k_like_jax(key_m, max_num)
    kvals = torch.gather(key_m, 1, kidx)
    certificate = kvals[:, -1] > torch.clamp(vals_m[:, -1], min=0.0)
    # host sync 2: one scalar decision for the whole batch, as in JAX
    if bool(torch.all(certificate)):
        return torch.gather(idx_m, 1, kidx)
    return pick_seeds_nms_fused(src, scores, radius, max_num, mask=mask)
