"""The seed stage after the seed k-NN: every seed's hypothesis, its inlier
count and the selection of the best (PyTorch wrappers of ``csrc/scoring.cu``;
counterparts of ``pointdsc_tpu/models/pointdsc.py:363-424`` and of the TPU
kernel ``pointdsc_tpu/kernels/scoring.py:27-171``).

``seed_hypotheses`` is the whole stage in three launches and no host sync:
the hypotheses (gather, k x k compatibility, power iteration, weighted
Procrustes; XLA glue on the TPU), ``seed_inlier_counts`` (the TPU's scoring
kernel) and ``select_hypothesis`` (fitness, argmax, the winner's transform
and labels). Each wrapper runs its plain version on a CPU tensor and
launches its kernel, or raises, on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import check_width, expect, on_cuda
from pointdsc_tpu_torch.ops.eig import power_iteration
from pointdsc_tpu_torch.ops.procrustes import horn_matrix, weighted_procrustes
from pointdsc_tpu_torch.ops.se3 import transform

MAX_HYP_SMEM = 200 * 1024  # the hypotheses kernel's shared-memory arena, bytes (csrc/scoring.cu)
ROW_FLOATS = 10  # its per-neighbour arrays: points, valid flag, index, v and the new v


def thr_sq(thr: float) -> float:
    t = np.float32(thr)
    return float(t * t)


# ---------------------------------------------------------------- plain versions

def _seed_weights(feats, knn_idx, src, tgt, mask, sigma, sigma_d, num_iterations):
    """The seeds' neighbours' src and tgt [B, S, k, 3] and their spectral
    weights [B, S, k], the input of the weighted Procrustes."""
    bs, _, c = feats.shape
    k = knn_idx.shape[-1]
    bundle = torch.cat([feats, src, tgt, mask.to(feats.dtype)[..., None]], dim=-1)  # [B, N, C+7]
    flat = knn_idx.reshape(bs, -1)
    g = torch.gather(bundle, 1, flat[..., None].expand(-1, -1, c + 7)).reshape(bs, -1, k, c + 7)
    knn_features = g[..., :c]
    src_knn = g[..., c:c + 3]
    tgt_knn = g[..., c + 3:c + 6]
    knn_mask = g[..., c + 6] > 0.5

    feat_M = torch.einsum("bskc,bsjc->bskj", knn_features, knn_features)
    feat_M = torch.clamp(1.0 - (1.0 - feat_M) / (sigma * sigma), min=0.0)

    def pdist(x):
        diff = x[..., :, None, :] - x[..., None, :, :]
        return torch.sqrt(torch.sum(diff * diff, dim=-1))

    spat_diff = pdist(src_knn) - pdist(tgt_knn)
    spat_M = torch.clamp(1.0 - spat_diff ** 2 / (sigma_d ** 2), min=0.0)
    total_M = feat_M * spat_M
    total_M = total_M * (1.0 - torch.eye(k, dtype=total_M.dtype, device=total_M.device))
    pair_mask = knn_mask[..., :, None] & knn_mask[..., None, :]
    total_M = torch.where(pair_mask, total_M, torch.zeros_like(total_M))

    weights = power_iteration(total_M, num_iterations)
    weights = torch.abs(weights) * knn_mask
    weights = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-6)
    return src_knn, tgt_knn, weights


def seed_transforms_plain(feats, knn_idx, src, tgt, mask, sigma, sigma_d, num_iterations):
    """[B, S, 4, 4] hypotheses from the seeds' k neighbours knn_idx [B, S, k]
    (JAX's ``_seed_transforms`` up to its Procrustes, in its order):
    feature compatibility clamp(1 - (1 - f.f) / sigma^2, 0), spatial
    compatibility from exact differences, zero diagonal and pair mask, the
    power iteration, weights |v| mask / (sum + 1e-6), weighted Procrustes.
    Differentiable in feats and sigma."""
    return weighted_procrustes(*_seed_weights(feats, knn_idx, src, tgt, mask, sigma, sigma_d,
                                              num_iterations))


def seed_trans_reference(feats, knn_idx, src, tgt, mask, sigma, sigma_d, num_iterations,
                         atol=1e-4):
    """The hypotheses of ``seed_transforms_plain`` in f64 on the same inputs,
    with each seed's tolerance for an f32 version against them: (trans
    [B, S, 4, 4] f64, tol_rot [B, S], tol_trans [B, S]). An f32 rotation
    moves with the rounding of H by about eps |N| / (l1 - l2), N Horn's 4 x 4
    and l1 > l2 its leading eigenvalues, so tol_rot = atol max(1, kappa / 8)
    with kappa = |N| / (l1 - l2) in f64 (0 where H = 0); the translation c_t - R c_s carries
    that error times |c_s|: tol_trans = tol_rot (1 + |c_s|)."""
    f64 = [x.double() for x in (feats, src, tgt, sigma)]
    src_knn, tgt_knn, w = _seed_weights(f64[0], knn_idx, f64[1], f64[2], mask, f64[3],
                                        sigma_d, num_iterations)
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-6
    c_s = torch.sum(src_knn * w[..., None], dim=-2) / wsum
    c_t = torch.sum(tgt_knn * w[..., None], dim=-2) / wsum
    H = torch.einsum("...ki,...k,...kj->...ij", src_knn - c_s[..., None, :], w,
                     tgt_knn - c_t[..., None, :])
    ev = torch.linalg.eigvalsh(horn_matrix(H))  # ascending
    scale = ev.abs().amax(dim=-1)
    # H = 0 (no weight: every version solves the same zero matrix)
    kappa = torch.where(scale > 0, scale / (ev[..., -1] - ev[..., -2]), torch.zeros_like(scale))
    tol_rot = atol * torch.clamp(kappa / 8.0, min=1.0)
    return (weighted_procrustes(src_knn, tgt_knn, w), tol_rot,
            tol_rot * (1.0 + torch.linalg.norm(c_s, dim=-1)))


def seed_inlier_counts_plain(seed_trans, src, tgt, thr2, mask=None):
    """Plain version of the scoring kernel, [B, S] f32: pred_i = (R_i0 x +
    R_i1 y) + R_i2 z + t_i, d2 < thr^2, masked sum."""
    x = src[:, None, :, 0]  # [B, 1, N]
    y = src[:, None, :, 1]
    z = src[:, None, :, 2]
    d2 = 0.0
    for i in range(3):
        row = seed_trans[:, :, i, :, None]  # [B, S, 4, 1]
        pred = row[:, :, 0] * x + row[:, :, 1] * y + row[:, :, 2] * z + row[:, :, 3]
        d2 = d2 + (pred - tgt[:, None, :, i]) ** 2
    inl = (d2 < torch.tensor(thr2, device=src.device)).float()
    if mask is not None:
        inl = inl * mask[:, None, :].float()
    return torch.sum(inl, dim=-1)


def select_hypothesis_plain(seed_trans, counts, seeds, src, tgt, thr, mask):
    """Plain version of the selection kernel: (seed_fitness [B, S] = counts /
    max(sum mask, 1), -1 for an invalid seed; final_trans [B, 4, 4], the
    first maximum's transform; final_labels [B, N] f32 of |T x - y| < thr
    and mask)."""
    bs = seed_trans.shape[0]
    denom = torch.clamp(torch.sum(mask, dim=-1), min=1)[:, None]
    seed_fitness = counts / denom
    seed_valid = torch.gather(mask, 1, seeds)
    seed_fitness = torch.where(seed_valid, seed_fitness, torch.full_like(seed_fitness, -1.0))
    best = torch.argmax(seed_fitness, dim=-1)  # [B]
    final_trans = seed_trans[torch.arange(bs, device=best.device), best]
    best_dis = torch.linalg.norm(transform(src, final_trans) - tgt, dim=-1)
    final_labels = ((best_dis < thr) & mask).float()
    return seed_fitness, final_trans, final_labels


def seed_hypotheses_plain(feats, seeds, knn_idx, src, tgt, mask, sigma, sigma_d,
                          inlier_threshold, num_iterations):
    """Plain version of ``seed_hypotheses``: the three plain versions in turn."""
    seed_trans = seed_transforms_plain(feats, knn_idx, src, tgt, mask, sigma, sigma_d,
                                       num_iterations)
    counts = seed_inlier_counts_plain(seed_trans.detach(), src, tgt, thr_sq(inlier_threshold),
                                      mask)
    return (seed_trans, *select_hypothesis_plain(seed_trans, counts, seeds, src, tgt,
                                                 inlier_threshold, mask))


# ---------------------------------------------------------------- wrappers

def _check_points(src, tgt, mask, b):
    expect(src, "src", dtype=torch.float32, ndim=3, last=3)
    if src.shape[0] != b:
        raise ValueError(f"src has batch {src.shape[0]}, expected {b}")
    expect(tgt, "tgt", dtype=torch.float32, shape=src.shape, device=src.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=src.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def hypotheses_layout(k: int, c: int) -> tuple[bool, bool]:
    """Where the hypotheses kernel keeps a seed's neighbour features (k x fs
    floats, fs = C rounded up to 4, plus 4) and M (k x (k + 1)): (features in
    a workspace, M in a workspace). Both stay in the shared-memory arena
    while they fit it beside the per-row arrays; past that M leaves first
    (about k = 180 at C = 128), then also the features."""
    fs = ((c + 3) & ~3) + 4
    rows = (ROW_FLOATS * k + 3) & ~3
    f, m, limit = k * fs, k * (k + 1), MAX_HYP_SMEM // 4
    if rows + f + m <= limit:
        return False, False
    if rows + f <= limit:
        return False, True
    if rows + m <= limit:
        return True, False
    return True, True


def _launch_hypotheses(feats, knn_idx, src, tgt, mask, sigma, sigma_d, num_iterations):
    """Launch 1, the hypotheses [B, S, 4, 4] f32 (rows of [R | t]), with the
    workspaces ``hypotheses_layout`` asks for."""
    b, n, c = feats.shape
    s, k = knn_idx.shape[1:]
    dev = feats.device
    trans = torch.empty((b, s, 4, 4), dtype=torch.float32, device=dev)
    f_ws, m_ws = hypotheses_layout(k, c)
    ws_f = torch.empty((b, s, k, ((c + 3) & ~3) + 4), dtype=torch.float32, device=dev) \
        if f_ws else None
    ws_m = torch.empty((b, s, k, k + 1), dtype=torch.float32, device=dev) if m_ws else None
    inv_sd2 = float(np.float32(1.0) / np.float32(sigma_d ** 2))
    _build.launch("scoring", "seed_hypotheses", dev, feats.data_ptr(),
                  knn_idx.data_ptr(), src.data_ptr(), tgt.data_ptr(), _ptr(mask),
                  sigma.data_ptr(), trans.data_ptr(), _ptr(ws_f), _ptr(ws_m), b, n, c, s, k,
                  num_iterations, inv_sd2)
    return trans


def seed_inlier_counts(seed_trans, src_keypts, tgt_keypts, thr, mask=None):
    """Inlier count of every seed transform over all correspondences.
    seed_trans [B, S, 4, 4], src/tgt [B, N, 3], mask [B, N] -> [B, S] f32.
    The kernel reads all of them in place."""
    expect(seed_trans, "seed_trans", dtype=torch.float32, ndim=4, last=4)
    b, s = seed_trans.shape[:2]
    expect(seed_trans, "seed_trans", shape=(b, s, 4, 4))
    _check_points(src_keypts, tgt_keypts, mask, b)
    if src_keypts.device != seed_trans.device:
        raise ValueError(f"src_keypts is on {src_keypts.device}, expected {seed_trans.device}")
    t2 = thr_sq(thr)
    if not on_cuda(seed_trans):
        return seed_inlier_counts_plain(seed_trans, src_keypts, tgt_keypts, t2, mask)
    n = src_keypts.shape[1]
    counts = torch.empty((b, s), dtype=torch.float32, device=seed_trans.device)
    seed_inlier_counts.launches += 1
    _build.launch("scoring", "seed_inlier_counts", seed_trans.device, seed_trans.data_ptr(),
                  src_keypts.data_ptr(), tgt_keypts.data_ptr(), _ptr(mask), counts.data_ptr(),
                  b, s, n, t2)
    return counts


seed_inlier_counts.launches = 0


def select_hypothesis(seed_trans, counts, seeds, src, tgt, thr, mask):
    """(seed_fitness [B, S], final_trans [B, 4, 4], final_labels [B, N] f32)
    from the counts [B, S] of seed_trans [B, S, 4, 4] and the seeds [B, S]
    int64 (an invalid seed's fitness is -1); the winner is the first
    maximum."""
    expect(seed_trans, "seed_trans", dtype=torch.float32, ndim=4, last=4)
    b, s = seed_trans.shape[:2]
    expect(counts, "counts", dtype=torch.float32, shape=(b, s), device=seed_trans.device)
    expect(seeds, "seeds", dtype=torch.int64, shape=(b, s), device=seed_trans.device)
    _check_points(src, tgt, mask, b)
    expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=seed_trans.device)
    if not on_cuda(seed_trans):
        return select_hypothesis_plain(seed_trans, counts, seeds, src, tgt, thr, mask)
    n = src.shape[1]
    dev = seed_trans.device
    fitness = torch.empty((b, s), dtype=torch.float32, device=dev)
    final_trans = torch.empty((b, 4, 4), dtype=torch.float32, device=dev)
    labels = torch.empty((b, n), dtype=torch.float32, device=dev)
    select_hypothesis.launches += 1
    _build.launch("scoring", "select_hypothesis", dev, seed_trans.data_ptr(), counts.data_ptr(),
                  seeds.data_ptr(), src.data_ptr(), tgt.data_ptr(), mask.data_ptr(),
                  fitness.data_ptr(), final_trans.data_ptr(), labels.data_ptr(), b, s, n,
                  float(np.float32(thr)))
    return fitness, final_trans, labels


select_hypothesis.launches = 0


def seed_hypotheses(feats, seeds, knn_idx, src, tgt, mask, sigma, sigma_d, inlier_threshold,
                    num_iterations):
    """The seed stage after the seed k-NN: (seed_trans [B, S, 4, 4],
    seed_fitness [B, S], final_trans [B, 4, 4], final_labels [B, N] f32)
    from feats [B, N, C] (L2-normalised f32), seeds [B, S] and their k
    neighbours knn_idx [B, S, k] (int64), src/tgt [B, N, 3], mask [B, N]
    bool and sigma (the model's one-element parameter, read on the device).

    On the card three launches and no host read: the hypotheses kernel
    (counted here; any k and C), then ``seed_inlier_counts`` and
    ``select_hypothesis``, which count their own. Nothing here carries a
    gradient on the card: the model calls it only when none is asked for.
    On the CPU, ``seed_hypotheses_plain``."""
    expect(feats, "feats", dtype=torch.float32, ndim=3)
    b, n, c = feats.shape
    expect(seeds, "seeds", dtype=torch.int64, ndim=2, device=feats.device)
    expect(knn_idx, "knn_idx", dtype=torch.int64, ndim=3, device=feats.device)
    s, k = knn_idx.shape[1:]
    if seeds.shape != (b, s) or knn_idx.shape[0] != b:
        raise ValueError(f"seeds {tuple(seeds.shape)} and knn_idx {tuple(knn_idx.shape)} do not "
                         f"fit feats {tuple(feats.shape)}")
    _check_points(src, tgt, mask, b)
    expect(mask, "mask", dtype=torch.bool, shape=(b, n), device=feats.device)
    expect(sigma, "sigma", dtype=torch.float32, shape=(1,), device=feats.device)
    if not on_cuda(feats):
        return seed_hypotheses_plain(feats, seeds, knn_idx, src, tgt, mask, sigma, sigma_d,
                                     inlier_threshold, num_iterations)
    check_width(c, "the hypotheses kernel")
    if k < 1:
        raise ValueError(f"the hypotheses kernel takes k >= 1, got k={k}")
    seed_hypotheses.launches += 1
    seed_trans = _launch_hypotheses(feats, knn_idx, src, tgt, mask, sigma, sigma_d,
                                    num_iterations)
    counts = seed_inlier_counts(seed_trans, src, tgt, inlier_threshold, mask=mask)
    return (seed_trans, *select_hypothesis(seed_trans, counts, seeds, src, tgt, inlier_threshold,
                                           mask))


seed_hypotheses.launches = 0
