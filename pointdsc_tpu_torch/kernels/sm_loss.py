"""Tile-wise spectral-matching loss (PyTorch wrappers of ``csrc/sm_loss.cu``;
counterpart of ``pointdsc_tpu/kernels/sm_loss.py``).

The dense chain materialises M = clamp(1 - (1 - F F^T) / sigma^2, 0, 1)
(zero diagonal) and takes a balanced MSE against the gt inlier outer product:
a [B, N, N] f32 chain in both passes. Here the forward kernel returns two
sums per sample ((M - 1)^2 over gt-positive pairs, M^2 over valid negative
pairs) and the backward kernel returns dF and dsigma; the denominators need
only label counts, so they are closed forms. ``fused_spectral_matching_loss``
is a drop-in for ``feature_similarity`` -> ``spectral_matching_loss``,
differentiable in (normed_features, sigma).

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its kernel or raises. The kernels take any C (F zero-padded to a
multiple of 128, dF sliced back; above 128 the tile products sum over the
128-wide chunks) and any N.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import (
    check_width,
    expect,
    on_cuda,
    pad_channels,
    unpad_channels,
)

TILE = 64  # the kernels' tile side
# f32 operations per pair beside the C-term product, counted from csrc/sm_loss.cu
OPS_PER_SM_PAIR = 14  # u (3), clip and diagonal (3), pm and gtM (3), two squared terms (5)
OPS_PER_SM_BWD_PAIR = 24  # the forward's M terms (9), g (8), gate (4), dsigma term (3)


def sm_loss_work(bs: int, n: int, c: int = 128) -> dict:
    """The least work of the two SM-loss kernels on bs samples of n points
    at width c: {"sums", "grads"} -> (bytes, operations). Bytes: the features
    read once (dF written once by the gradients), the label strips and the
    scalars, and the per-tile partial sums written. Operations: 2 C per pair
    for the feature product (4 C for the gradients' two), and the pair terms."""
    act, strip_bytes = bs * n * c * 4, (8 * bs * n + 4 * bs) * 4
    tiles, pairs = -(-n // TILE), float(bs) * n * n
    return {"sums": (act + strip_bytes + bs * tiles * tiles * 8,
                     pairs * (2 * c + OPS_PER_SM_PAIR)),
            "grads": (2 * act + strip_bytes + bs * tiles * 4,
                      pairs * (4 * c + OPS_PER_SM_BWD_PAIR))}


def pack_labels(gt_labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, 8, N] strip: row 0 gt (masked to 0), row 1 valid (1 / 0)."""
    b, n = gt_labels.shape
    strips = torch.zeros((b, 8, n), dtype=gt_labels.dtype, device=gt_labels.device)
    m = mask.to(gt_labels.dtype)
    strips[:, 0] = gt_labels * m
    strips[:, 1] = m
    return strips


def balance_weights(strips: torch.Tensor, balanced: bool):
    """Per-sample multipliers (wp, wn) on the raw sums, chosen so that the
    assembled scalar equals the dense loss. Pair counts in closed form:
    off-diagonal positive pairs, and valid negative pairs with the diagonal
    included, as in the dense denominators."""
    s_gt = torch.sum(strips[:, 0], dim=-1)
    s_m = torch.sum(strips[:, 1], dim=-1)
    npos = s_gt * s_gt - s_gt
    nneg = s_m * s_m - npos
    denom_p = torch.clamp(npos - 1.0, min=0.0) + 1.0
    denom_n = torch.clamp(nneg - 1.0, min=0.0) + 1.0
    if balanced:
        batch = float(strips.shape[0])
        return 0.5 / (batch * denom_p), 0.5 / (batch * denom_n)
    total = torch.clamp(torch.sum(npos + nneg), min=1.0)
    wp = torch.ones_like(denom_p) / total
    return wp, wp


def _tile_terms(f, strips, scalars):
    """(S, u, M, pm, gtM, offdiag) of the dense chain, the kernels' formulas."""
    n = f.shape[1]
    sigma = scalars[:, 0, None, None]
    s = torch.einsum("bnc,bmc->bnm", f, f)
    u = 1.0 - (1.0 - s) / (sigma * sigma)
    offdiag = 1.0 - torch.eye(n, dtype=f.dtype, device=f.device)
    m = torch.clamp(u, 0.0, 1.0) * offdiag
    gt, valid = strips[:, 0], strips[:, 1]
    pm = valid[:, :, None] * valid[:, None, :]
    gtm = gt[:, :, None] * gt[:, None, :] * offdiag
    return s, u, m, pm, gtm, offdiag


def sm_loss_sums_plain(f, strips, scalars):
    """Plain version of the forward kernel: (sum_p, sum_n), [B] each."""
    _, _, m, pm, gtm, _ = _tile_terms(f, strips, scalars)
    return (torch.sum((m - 1.0) ** 2 * gtm, dim=(1, 2)),
            torch.sum(m * m * (pm - gtm), dim=(1, 2)))


def sm_loss_grads_plain(f, strips, scalars):
    """Plain version of the backward kernel: (dF [B, N, C], dsigma [B]) for a
    unit cotangent of sum_b wp sum_p + wn sum_n."""
    s, u, m, pm, gtm, offdiag = _tile_terms(f, strips, scalars)
    sigma = scalars[:, 0]
    wp, wn = scalars[:, 1, None, None], scalars[:, 2, None, None]
    g = wp * 2.0 * (m - 1.0) * gtm + wn * 2.0 * m * (pm - gtm)
    gate = ((u > 0.0) & (u < 1.0)).to(f.dtype) * offdiag * pm
    gg = g * gate
    # the factor 2 stands for the mirrored tile (g and gate are symmetric)
    df = (2.0 / (sigma * sigma))[:, None, None] * torch.einsum("bnm,bmc->bnc", gg, f)
    dsigma = torch.sum(gg * 2.0 * (1.0 - s), dim=(1, 2)) / (sigma * sigma * sigma)
    return df, dsigma


def _check(f, strips, scalars) -> bool:
    expect(f, "f", ndim=3)
    cuda = on_cuda(f)
    dtype = torch.float32 if cuda else f.dtype
    expect(f, "f", dtype=dtype)
    b, n, c = f.shape
    expect(strips, "strips", dtype=dtype, shape=(b, 8, n), device=f.device)
    expect(scalars, "scalars", dtype=dtype, shape=(b, 4), device=f.device)
    if cuda:
        check_width(c, "the SM-loss kernels")
    return cuda


def sm_loss_sums(f, strips, scalars):
    """(sum_p, sum_n) per sample from F [B, N, C], label strips [B, 8, N] and
    scalars [B, 4] (sigma, wp, wn, unused). Each block of the kernel writes
    its partial sums; they are added here in a fixed order."""
    if not _check(f, strips, scalars):
        return sm_loss_sums_plain(f, strips, scalars)
    b, n, _ = f.shape
    f = pad_channels(f)
    tiles = -(-n // TILE)
    partial = torch.empty((b, tiles * tiles, 2), dtype=torch.float32, device=f.device)
    sm_loss_sums.launches += 1
    _build.launch("sm_loss", "sm_loss_fwd", f.device, f.data_ptr(), strips.data_ptr(),
                  scalars.data_ptr(), partial.data_ptr(), b, n, f.shape[-1])
    sums = torch.sum(partial, dim=1)
    return sums[:, 0], sums[:, 1]


def sm_loss_grads(f, strips, scalars):
    """(dF [B, N, C], dsigma [B]) for a unit cotangent of the loss."""
    if not _check(f, strips, scalars):
        return sm_loss_grads_plain(f, strips, scalars)
    b, n, c = f.shape
    f = pad_channels(f)
    tiles = -(-n // TILE)
    df = torch.empty_like(f)
    partial = torch.empty((b, tiles), dtype=torch.float32, device=f.device)
    sm_loss_grads.launches += 1
    _build.launch("sm_loss", "sm_loss_bwd", f.device, f.data_ptr(), strips.data_ptr(),
                  scalars.data_ptr(), df.data_ptr(), partial.data_ptr(), b, n, f.shape[-1])
    return unpad_channels(df, c), torch.sum(partial, dim=1)


sm_loss_sums.launches = 0
sm_loss_grads.launches = 0


class _FusedSMLoss(torch.autograd.Function):
    """Saves (F, strips, scalars). sigma reaches the kernels through the
    ``scalars`` tensor on the device, never through the host."""

    @staticmethod
    def forward(ctx, f, sigma, strips, wp, wn):
        f = f.contiguous()
        b = f.shape[0]
        sig = sigma.reshape(1).to(f.dtype).expand(b)
        scalars = torch.stack([sig, wp, wn, torch.zeros_like(wp)], dim=-1).contiguous()
        sum_p, sum_n = sm_loss_sums(f, strips, scalars)
        ctx.save_for_backward(f, strips, scalars)
        ctx.sigma_shape = sigma.shape
        return torch.sum(wp * sum_p + wn * sum_n)

    @staticmethod
    def backward(ctx, d_loss):
        f, strips, scalars = ctx.saved_tensors
        df, dsigma = sm_loss_grads(f, strips, scalars)
        return d_loss * df, (d_loss * torch.sum(dsigma)).reshape(ctx.sigma_shape), None, None, None


def fused_spectral_matching_loss(normed_features, sigma, gt_labels, mask=None,
                                 balanced: bool = True):
    """The spectral-matching loss of ``train/losses.py`` on
    ``feature_similarity(normed_features, sigma)`` without forming M.

    normed_features [B, N, C] L2-normalised, sigma a one-element tensor (the
    model's parameter), gt_labels [B, N] 0/1, mask [B, N] bool or None.
    Labels and mask carry no gradient."""
    f = normed_features
    gt = gt_labels.to(f.dtype)
    if mask is None:
        mask = torch.ones(gt.shape, dtype=torch.bool, device=gt.device)
    strips = pack_labels(gt, mask)
    wp, wn = balance_weights(strips, balanced)
    return _FusedSMLoss.apply(f, sigma, strips, wp, wn)
