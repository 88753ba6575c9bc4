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
128-wide chunks) and any N. At C = 128 the launch plans are this module's:
the sums kernel's work items over the triangle of pairs (``sums_plan``) and
the gradients kernel's split of each row block's walk (``grads_plan``); the
C entries launch the plan they are given and refuse one that does not cover
their tiles.
"""

from __future__ import annotations

import functools

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import (
    check_width,
    expect,
    on_cuda,
    pad_channels,
    unpad_channels,
)
from pointdsc_tpu_torch.parallel.distributed import global_sum, group_size

OWN = 64  # rows a block of either kernel owns (csrc/sm_loss.cu); the tile side above C = 128
TILE = 32  # rows of the tiles a block walks at C = 128
# the plans (csrc/sm_loss.cu's notes; both kernels run one block an SM): the
# sums are cut into work items of at most MAX_RUN tiles, at least one an SM;
# the gradients' walk is split in two where that fills the card's last wave by
# at least SPLIT_GAIN more
MAX_RUN = 64
SPLIT_GAIN = 0.1
# f32 operations per pair beside the C-term product, counted from csrc/sm_loss.cu
OPS_PER_SM_PAIR = 14  # u (3), clip and diagonal (3), pm and gtM (3), two squared terms (5)
OPS_PER_SM_BWD_PAIR = 24  # the forward's M terms (9), g (8), gate (4), dsigma term (3)


def sm_loss_work(bs: int, n: int, c: int = 128) -> dict:
    """The least work of the two SM-loss kernels on bs samples of n points
    at width c: {"sums", "grads"} -> (bytes, operations). Bytes: the features
    read once (dF written once by the gradients), the label strips and the
    scalars, and the outputs written (two sums, or dsigma, a sample).
    Operations: 2 C for the feature product and the pair terms for each of
    the bs n (n - 1) / 2 unordered pairs of the sums, whose every term is
    symmetric in (i, j) and whose diagonal terms are 0; 4 C for the two
    products and the pair terms for each of the bs n^2 ordered pairs of the
    gradients, whose dF rows each have one owner."""
    act, strip_bytes = bs * n * c * 4, (8 * bs * n + 4 * bs) * 4
    return {"sums": (act + strip_bytes + bs * 8,
                     float(bs) * n * (n - 1) / 2 * (2 * c + OPS_PER_SM_PAIR)),
            "grads": (2 * act + strip_bytes + bs * 4,
                      float(bs) * n * n * (4 * c + OPS_PER_SM_BWD_PAIR))}


def sums_plan(batch: int, n: int, sms: int) -> list[tuple[int, int, int]]:
    """Work items (owned block o, first tile, tiles) of the sums kernel at
    C = 128, longest first. Owned block o (rows 64 o ..) walks the 32-row
    tiles from its diagonal block on, 2 o .. ceil(n / 32) - 1, cut into runs
    of near-equal length of at most ``run`` tiles: the batch's tiles over the
    ``sms`` SMs, at most MAX_RUN. A block's fixed cost (its owned rows, its
    first tile, its sums) is paid once an item, so long items win while the
    longest-first order keeps the last of them short."""
    tiles, blocks = -(-n // TILE), -(-n // OWN)
    walks = [tiles - 2 * o for o in range(blocks)]
    run = max(1, min(MAX_RUN, batch * sum(walks) // sms))
    items = []
    for o, walk in enumerate(walks):
        runs = -(-walk // run)
        size, longer = divmod(walk, runs)
        first = 2 * o
        for r in range(runs):
            count = size + (r < longer)
            items.append((o, first, count))
            first += count
    return sorted(items, key=lambda it: (-it[2], it[0], it[1]))


def grads_plan(batch: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, run) of the gradients kernel at C = 128: each row block's walk
    over the ceil(n / 32) tiles in ``splits`` consecutive runs of ``run``
    tiles, none empty. Two where the batch ceil(n / 64) row blocks, one an SM,
    fill the last of their waves on ``sms`` SMs at least SPLIT_GAIN less than
    twice as many blocks would."""
    tiles, blocks = -(-n // TILE), batch * -(-n // OWN)

    def fill(splits):
        return blocks * splits / (-(-blocks * splits // sms) * sms)

    splits = 2 if tiles > 1 and fill(2) >= fill(1) + SPLIT_GAIN else 1
    return splits, -(-tiles // splits)


@functools.lru_cache(maxsize=None)
def _sums_plan_on(batch: int, n: int, device: torch.device) -> torch.Tensor:
    """``sums_plan`` as the kernel reads it, [items, 3] int32 on ``device``
    (made once a shape: a read-only table)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return torch.tensor(sums_plan(batch, n, sms), dtype=torch.int32, device=device)


def pack_labels(gt_labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, 8, N] strip: row 0 gt (masked to 0), row 1 valid (1 / 0)."""
    b, n = gt_labels.shape
    strips = torch.zeros((b, 8, n), dtype=gt_labels.dtype, device=gt_labels.device)
    m = mask.to(gt_labels.dtype)
    strips[:, 0] = gt_labels * m
    strips[:, 1] = m
    return strips


def balance_weights(strips: torch.Tensor, balanced: bool, group=None):
    """Per-sample multipliers (wp, wn) on the raw sums, chosen so that the
    assembled scalar equals the dense loss. Pair counts in closed form:
    off-diagonal positive pairs, and valid negative pairs with the diagonal
    included, as in the dense denominators. Under ``group`` the batch size
    and the pair total are the global batch's."""
    s_gt = torch.sum(strips[:, 0], dim=-1)
    s_m = torch.sum(strips[:, 1], dim=-1)
    npos = s_gt * s_gt - s_gt
    nneg = s_m * s_m - npos
    denom_p = torch.clamp(npos - 1.0, min=0.0) + 1.0
    denom_n = torch.clamp(nneg - 1.0, min=0.0) + 1.0
    if balanced:
        batch = float(strips.shape[0] * group_size(group))
        return 0.5 / (batch * denom_p), 0.5 / (batch * denom_n)
    total = torch.clamp(global_sum(torch.sum(npos + nneg), group), min=1.0)
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


def _grad_terms(f, strips, scalars):
    """(S, u, g, the valid off-diagonal pairs) of the backward, and its
    coefficient 2 / sigma^2 [B, 1, 1]."""
    s, u, m, pm, gtm, offdiag = _tile_terms(f, strips, scalars)
    sigma = scalars[:, 0]
    wp, wn = scalars[:, 1, None, None], scalars[:, 2, None, None]
    g = wp * 2.0 * (m - 1.0) * gtm + wn * 2.0 * m * (pm - gtm)
    return s, u, g, offdiag * pm, (2.0 / (sigma * sigma))[:, None, None]


def sm_loss_grads_plain(f, strips, scalars):
    """Plain version of the backward kernel: (dF [B, N, C], dsigma [B]) for a
    unit cotangent of sum_b wp sum_p + wn sum_n."""
    s, u, g, pairs, coef = _grad_terms(f, strips, scalars)
    sigma = scalars[:, 0]
    gg = g * ((u > 0.0) & (u < 1.0)).to(f.dtype) * pairs
    # the factor 2 stands for the mirrored tile (g and gate are symmetric)
    df = coef * torch.einsum("bnm,bmc->bnc", gg, f)
    dsigma = torch.sum(gg * 2.0 * (1.0 - s), dim=(1, 2)) / (sigma * sigma * sigma)
    return df, dsigma


def grads_gate_slack(f, strips, scalars, window: float = 1e-6):
    """[B, N, C]: how far dF may move when the gates of the pairs whose u lies
    within ``window`` of 0 or 1 fall on the other side. The gradient is
    discontinuous there (the gate opens, g stays), so two versions whose S
    differ by rounding may disagree by one term (2 / sigma^2) |g| |F_j| for
    each such pair; every other entry of dF is continuous in S."""
    _, u, g, pairs, coef = _grad_terms(f, strips, scalars)
    near = ((u.abs() <= window) | ((u - 1.0).abs() <= window)).to(f.dtype) * pairs
    return coef * torch.einsum("bnm,bmc->bnc", g.abs() * near, f.abs())


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
    ld = f.shape[-1]
    if ld == 128:  # [items, B, 2] partials
        plan = _sums_plan_on(b, n, f.device)
        items, plan_ptr, shape = plan.shape[0], plan.data_ptr(), (plan.shape[0], b, 2)
    else:  # [B, tiles^2, 2] partials, 64 x 64 tiles
        items, plan_ptr, shape = 0, None, (b, (-(-n // OWN)) ** 2, 2)
    partial = torch.empty(shape, dtype=torch.float32, device=f.device)
    sm_loss_sums.launches += 1
    _build.launch("sm_loss", "sm_loss_fwd", f.device, f.data_ptr(), strips.data_ptr(),
                  scalars.data_ptr(), plan_ptr, items, partial.data_ptr(), b, n, ld)
    sums = torch.sum(partial, dim=0 if items else 1)
    return sums[:, 0], sums[:, 1]


def sm_loss_grads(f, strips, scalars):
    """(dF [B, N, C], dsigma [B]) for a unit cotangent of the loss. Where the
    plan splits the walk, the second run's dF is added here to the first's;
    the per-block dsigma partials are added in a fixed order."""
    if not _check(f, strips, scalars):
        return sm_loss_grads_plain(f, strips, scalars)
    b, n, c = f.shape
    f = pad_channels(f)
    ld = f.shape[-1]
    splits, run = (1, 0) if ld != 128 else grads_plan(
        b, n, torch.cuda.get_device_properties(f.device).multi_processor_count)
    df = torch.empty_like(f)
    df_split = torch.empty_like(f) if splits > 1 else None
    partial = torch.empty((splits, b, -(-n // OWN)), dtype=torch.float32, device=f.device)
    sm_loss_grads.launches += 1
    _build.launch("sm_loss", "sm_loss_bwd", f.device, f.data_ptr(), strips.data_ptr(),
                  scalars.data_ptr(), df.data_ptr(),
                  None if df_split is None else df_split.data_ptr(), partial.data_ptr(),
                  b, n, ld, splits, run)
    if df_split is not None:
        df.add_(df_split)
    return unpad_channels(df, c), torch.sum(partial, dim=(0, 2))


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
                                 balanced: bool = True, group=None):
    """The spectral-matching loss of ``train/losses.py`` on
    ``feature_similarity(normed_features, sigma)`` without forming M.

    normed_features [B, N, C] L2-normalised, sigma a one-element tensor (the
    model's parameter), gt_labels [B, N] 0/1, mask [B, N] bool or None.
    Labels and mask carry no gradient. Under ``group`` the loss is the
    global batch's: each process's share, summed over the group."""
    f = normed_features
    gt = gt_labels.to(f.dtype)
    if mask is None:
        mask = torch.ones(gt.shape, dtype=torch.bool, device=gt.device)
    strips = pack_labels(gt, mask)
    wp, wn = balance_weights(strips, balanced, group)
    return global_sum(_FusedSMLoss.apply(f, sigma, strips, wp, wn), group)
