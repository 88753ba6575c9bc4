"""Spatial-consistency attention kernels (PyTorch wrappers of
``csrc/compat_cache.cu``, ``csrc/compat_cache_sym.cu``,
``csrc/sc_attention_cached.cu``, ``csrc/sc_attention.cu`` and
``csrc/sc_attention_train.cu``; counterparts of
``pointdsc_tpu/kernels/sc_attention.py``).

Eval: the 12 encoder layers share one compat matrix, built once as int8
(value = round(127 * compat)) by the full-grid kernel or, where the card
measured it faster (``use_symmetric_cache``), by the symmetric one, which
computes each unordered pair once; each layer streams it through the offset or
the running-max attention kernel. Without a cache (``fused_sc_attention``,
the running-max kernel on bf16 operands) and in training
(``sc_attention_trainable``, a ``torch.autograd.Function`` with an f32
forward kernel that saves the row LSE and two backward kernels) the compat
tile is recomputed from the packed geometry, so nothing [N, N] exists in
either pass. On a CPU tensor each wrapper runs its plain PyTorch version;
on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import (
    check_width,
    expect,
    expect_aligned,
    on_cuda,
    pad_channels,
    unpad_channels,
)

_NEG = -1e9


def pack_geometry(src: torch.Tensor, tgt: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 16, N] f32 strip: rows 0-2 src xyz, 3 |src|^2, 4-6 tgt xyz,
    7 |tgt|^2, 8 key bias (0 valid / -1e9 invalid), 9-15 zeros."""
    b, n, _ = src.shape
    src = src.float()
    tgt = tgt.float()
    geom = torch.zeros((b, 16, n), dtype=torch.float32, device=src.device)
    geom[:, 0:3] = src.transpose(1, 2)
    geom[:, 3] = torch.sum(src * src, dim=-1)
    geom[:, 4:7] = tgt.transpose(1, 2)
    geom[:, 7] = torch.sum(tgt * tgt, dim=-1)
    geom[:, 8] = key_bias(mask, b, n, src.device)
    return geom


def key_bias(mask: torch.Tensor | None, b: int, n: int, device) -> torch.Tensor:
    """Row 8 of ``pack_geometry`` alone, [B, N]: 0 valid, -1e9 invalid."""
    if mask is None:
        return torch.zeros((b, n), dtype=torch.float32, device=device)
    return torch.where(mask, 0.0, _NEG).to(torch.float32)


def cache_coef(sigma_d: float) -> float:
    """127 / sigma_d^2 evaluated in float32, as the TPU kernel does."""
    sig = np.float32(sigma_d)
    return float(np.float32(127.0) / (sig * sig))


def compat_cache_plain(geom: torch.Tensor, coef: float,
                       geom_cols: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the cache kernel: gram-form distances, one-sqrt
    difference, round(max(127 - coef * diff2, 0)) clamped at 127. With
    ``geom_cols`` (JAX's argument of that name) the rows come from ``geom``
    [B, 16, Nq] and the columns from ``geom_cols`` [B, 16, Nk]: the
    rectangular [B, Nq, Nk] slice."""
    cols = geom if geom_cols is None else geom_cols
    gs, gt = geom[:, 0:3], geom[:, 4:7]
    # the square product takes one operand twice, as it always has (the
    # CPU's product rounds it as a symmetric one)
    ks, kt = (gs, gt) if geom_cols is None else (cols[:, 0:3], cols[:, 4:7])
    inner_s = gs.transpose(1, 2) @ ks
    inner_t = gt.transpose(1, 2) @ kt
    s2 = torch.clamp(geom[:, 3, :, None] + cols[:, 3, None, :] - 2.0 * inner_s, min=0.0)
    t2 = torch.clamp(geom[:, 7, :, None] + cols[:, 7, None, :] - 2.0 * inner_t, min=0.0)
    diff2 = s2 + t2 - 2.0 * torch.sqrt(s2 * t2)
    scaled = 127.0 - diff2 * torch.tensor(coef, dtype=torch.float32, device=geom.device)
    return torch.clamp(torch.round(torch.clamp(scaled, min=0.0)), max=127.0).to(torch.int8)


def _launch_compat_cache_rect(src: torch.Tensor, tgt: torch.Tensor, src_cols: torch.Tensor,
                              tgt_cols: torch.Tensor, coef: float) -> torch.Tensor:
    """Rows src, tgt f32 [B, Nq, 3], columns src_cols, tgt_cols f32
    [B, Nk, 3], contiguous: the [B, Nq, Nk] slice in one launch."""
    b, nq, _ = src.shape
    nk = src_cols.shape[1]
    out = torch.empty((b, nq, nk), dtype=torch.int8, device=src.device)
    _build.launch("compat_cache", "compat_cache_int8_rect", src.device, src.data_ptr(),
                  tgt.data_ptr(), src_cols.data_ptr(), tgt_cols.data_ptr(), out.data_ptr(), b,
                  nq, nk, coef)
    return out


def _launch_compat_cache(src: torch.Tensor, tgt: torch.Tensor, coef: float) -> torch.Tensor:
    """src, tgt f32 [B, N, 3], contiguous: the whole cache in one launch,
    the squared norms computed by the kernel (no packed strip)."""
    b, n, _ = src.shape
    out = torch.empty((b, n, n), dtype=torch.int8, device=src.device)
    _build.launch("compat_cache", "compat_cache_int8", src.device,
                  src.data_ptr(), tgt.data_ptr(), out.data_ptr(), b, n, coef)
    return out


# the symmetric kernel's shape (csrc/compat_cache_sym.cu): a block owns a
# strip of SYM_COLS key columns and computes its rows in bands of SYM_BAND;
# SYM_BLOCKS_PER_SM blocks are resident on an SM
SYM_COLS, SYM_BAND, SYM_BLOCKS_PER_SM = 512, 32, 2
# the work of a band, in twentieths of a band above the diagonal block: a band
# of that block costs 1.75 of them, each of its rows holding a zero distance
# (the diagonal) whose row the kernel computes again with sqrtf (the fastest of
# 1.75, 1.9 and 2.0 kernel only on an NVIDIA H100 80GB HBM3 at 700 W: by 5% at
# 12288, the same elsewhere; tools/time_attention.py --cases symcache_weights,
# PERF.md, row 15)
SYM_BAND_COST, SYM_DIAGONAL_COST = 20, 35
# the least N at which the symmetric kernel beat the full-grid one, kernel
# only, in the same run (PERF.md, row 15: 0.97x at 3072, 0.94x at 4096, 1.40x
# at 2048)
SYM_MIN_N = 3072
# f32 operations an entry: two 3-dots (10), two gram distances (8), the
# one-sqrt difference (5), the scale and the rounding (5)
OPS_PER_CACHE_ENTRY = 28


def compat_cache_work(bs: int, n: int) -> tuple[float, float]:
    """The least work of a cache build on bs samples of n points, (bytes,
    operations): src and tgt read once, the n^2 bytes written once, and each
    of the n (n + 1) / 2 unordered pairs (the diagonal's included) computed
    once, the matrix being symmetric."""
    return (float(bs) * (2 * n * 3 * 4 + n * n),
            float(bs) * n * (n + 1) / 2 * OPS_PER_CACHE_ENTRY)


def use_symmetric_cache(n: int) -> bool:
    """Whether the card builds the cache of N = n points with the symmetric
    kernel (the same bytes as the full-grid one): from SYM_MIN_N on."""
    return n >= SYM_MIN_N


def symmetric_band_costs(n: int) -> list[list[int]]:
    """The work of each band of each strip of the symmetric kernel: strip s
    (key columns SYM_COLS s ..) computes the bands 0 ..
    ceil(min(SYM_COLS (s + 1), n) / SYM_BAND) - 1 of its rows, those above
    its diagonal block (mirrored) at SYM_BAND_COST, then that block's at
    SYM_DIAGONAL_COST."""
    costs = []
    for s in range(-(-n // SYM_COLS)):
        walk, above = -(-min(SYM_COLS * (s + 1), n) // SYM_BAND), SYM_COLS // SYM_BAND * s
        costs.append([SYM_BAND_COST] * above + [SYM_DIAGONAL_COST] * (walk - above))
    return costs


def _cut(costs: list[int], limit: int) -> list[tuple[int, int]]:
    """Runs (first band, bands) of consecutive bands, each of work at most
    ``limit`` unless one band alone is more: the fewest such runs."""
    runs, first, acc = [], 0, 0
    for band, cost in enumerate(costs):
        if acc + cost > limit and band > first:
            runs.append((first, band - first))
            first, acc = band, 0
        acc += cost
    runs.append((first, len(costs) - first))
    return runs


def symmetric_cache_plan(batch: int, n: int, sms: int) -> list[tuple[int, int, int]]:
    """Work items (strip, first band, bands) of the symmetric kernel, the
    most work first. Each strip's walk (``symmetric_band_costs``) is cut into
    runs of consecutive bands: the least work a run for which the batch's
    items fit the ``sms`` SMs' resident blocks (one wave), and within a strip
    the runs as even as its count of them allows."""
    costs = symmetric_band_costs(n)
    slots = max(1, SYM_BLOCKS_PER_SM * sms // batch)

    def least(walks, count):  # the least limit that cuts walks into count runs at most
        lo = max(max(max(c) for c in walks), -(-sum(map(sum, walks)) // count))
        hi = max(map(sum, walks))
        while lo < hi:
            mid = (lo + hi) // 2
            if sum(len(_cut(c, mid)) for c in walks) > count:
                lo = mid + 1
            else:
                hi = mid
        return lo

    limit = least(costs, max(slots, len(costs)))
    items = []
    for s, walk in enumerate(costs):
        runs = _cut(walk, least([walk], len(_cut(walk, limit))))
        items += [(s, first, count, sum(walk[first:first + count])) for first, count in runs]
    return [it[:3] for it in sorted(items, key=lambda it: (-it[3], it[0], it[1]))]


@functools.lru_cache(maxsize=None)
def _symmetric_plan_on(batch: int, n: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """``symmetric_cache_plan`` as the kernel reads it, [items, 3] int32 on
    ``device`` (made once a shape: a read-only table), and its band total."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = symmetric_cache_plan(batch, n, sms)
    return (torch.tensor(plan, dtype=torch.int32, device=device),
            sum(count for _, _, count in plan))


def _launch_compat_cache_sym(src: torch.Tensor, tgt: torch.Tensor, coef: float) -> torch.Tensor:
    """src, tgt f32 [B, N, 3], contiguous: the cache in one launch of the
    symmetric kernel (each unordered pair once, the mirror written from the
    computation)."""
    b, n, _ = src.shape
    plan, bands = _symmetric_plan_on(b, n, src.device)
    out = torch.empty((b, n, n), dtype=torch.int8, device=src.device)
    _build.launch("compat_cache_sym", "compat_cache_sym", src.device, src.data_ptr(),
                  tgt.data_ptr(), plan.data_ptr(), plan.shape[0], bands, out.data_ptr(), b, n,
                  coef)
    return out


def build_compat_cache_int8(src: torch.Tensor, tgt: torch.Tensor, sigma_d: float,
                            mask: torch.Tensor | None = None,
                            src_cols: torch.Tensor | None = None,
                            tgt_cols: torch.Tensor | None = None) -> torch.Tensor:
    """[B, N, N] int8 cache of round(127 * compat) from src/tgt [B, N, 3].
    Nothing is masked: the attention's key bias handles invalid keys (the
    mask, [B, N] of the columns, is checked and otherwise unused). On the
    card one launch reads src and tgt in place: the symmetric kernel where
    ``use_symmetric_cache``, else the full-grid one (the same bytes); either
    is one launch here.

    With ``src_cols`` and ``tgt_cols`` [B, Nk, 3] (JAX's ``geom_cols``) the
    rows are src/tgt [B, Nq, 3] and the result the rectangular [B, Nq, Nk]
    slice, a row shard's of the sequence-parallel encoder: one launch of the
    rectangular kernel, whose rows hold the square cache's bytes."""
    expect(src, "src", ndim=3, last=3)
    expect(tgt, "tgt", shape=src.shape, device=src.device)
    rect = src_cols is not None or tgt_cols is not None
    if rect:
        expect(src_cols, "src_cols", ndim=3, last=3, device=src.device)
        if src_cols.shape[0] != src.shape[0]:
            raise ValueError(f"src_cols holds {src_cols.shape[0]} samples, src {src.shape[0]}")
        expect(tgt_cols, "tgt_cols", shape=src_cols.shape, device=src.device)
    keys = src_cols if rect else src
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=keys.shape[:2], device=src.device)
    coef = cache_coef(sigma_d)
    if not on_cuda(src):
        if rect:
            return compat_cache_plain(pack_geometry(src, tgt), coef,
                                      pack_geometry(src_cols, tgt_cols, mask))
        return compat_cache_plain(pack_geometry(src, tgt, mask), coef)
    build_compat_cache_int8.launches += 1
    if rect:
        return _launch_compat_cache_rect(*(t.float() for t in (src, tgt, src_cols, tgt_cols)),
                                         coef)
    launch = (_launch_compat_cache_sym if use_symmetric_cache(src.shape[1])
              else _launch_compat_cache)
    return launch(src.float(), tgt.float(), coef)


build_compat_cache_int8.launches = 0


def inv_sqrt_c(c: int) -> float:
    """1/sqrt(C) rounded once to float32, as JAX rounds the Python constant."""
    return float(np.float32(1.0 / (c ** 0.5)))


def qk_scale(c: int) -> float:
    """1/sqrt(C)/127 rounded once to float32 (as JAX rounds the Python
    constant): the int8 decode folded into the qk scale."""
    return float(np.float32(1.0 / (c ** 0.5) / 127.0))


def sc_attention_cached_plain(q, k, v, compat, key_bias, c=None):
    """Plain version of the running-max attention kernel on the same inputs:
    softmax(compat * (q k^T * scale) + bias) v with the kernel's
    acc / (l + 1e-30) normalisation. q, k, v f32, or bf16, and then the
    product runs in f32 on the bf16 values and p is rounded to bf16 before
    p v, with l summed from the unrounded p (the offset version's rule).
    ``c``: the model's width, whose 1/sqrt(C) the scale takes (q's last
    dimension when None; a zero-padded q passes the unpadded width)."""
    round_p = q.dtype == torch.bfloat16
    q, k, v = q.float(), k.float(), v.float()
    scale = torch.tensor(qk_scale(c or q.shape[-1]), dtype=torch.float32, device=q.device)
    logits = torch.einsum("bnc,bmc->bnm", q, k) * scale
    s = compat.float() * logits + key_bias[:, None, :]
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=_NEG)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).float()
    return torch.einsum("bnm,bmc->bnc", p, v) / (l + 1e-30)


# The running-max cached kernel at C = 128 (csrc/sc_attention_cached.cu): a
# work item is a query tile of ATTN_ROWS rows over a run of key tiles of
# ATTN_KEYS keys; one block an SM (its shared memory leaves room for no second).
ATTN_ROWS = ATTN_KEYS = 128
ATTN_WIDTH = 128  # the channels it takes (a wider model runs the wide kernel)


class AttentionPlan(NamedTuple):
    """The work of the running-max cached kernel at C = 128 for one shape
    (``cached_attention_plan``)."""

    items: tuple  # (sample, query tile, first key tile, key tiles, slot; -1: writes out)
    first: tuple  # block i runs items first[i] .. first[i + 1] - 1
    merges: tuple  # the split query tiles: (sample, query tile, first slot, slots)
    slots: int  # the workspace's (m, l, acc) slots, one a split item
    splits: int  # query tiles whose keys more than one block walks


def cached_attention_plan(batch: int, n: int, sms: int) -> AttentionPlan:
    """Work items of the running-max cached kernel at N = n: the (sample,
    query tile, key tile) sequence cut into min(sms, its length) runs of
    equal length (within one key tile), one a block, so the launch is one
    wave, every SM busy alike. A run is cut at its query tiles' edges into
    items; a query tile that more than one item walks is split, each of its
    items writing a workspace slot, which the merge launch combines."""
    tiles, keys = -(-n // ATTN_ROWS), -(-n // ATTN_KEYS)
    total = batch * tiles * keys
    blocks = min(sms, total)
    items, first = [], [0]
    for i in range(blocks):
        pos, end = i * total // blocks, (i + 1) * total // blocks
        while pos < end:
            row, k0 = divmod(pos, keys)
            count = min(keys - k0, end - pos)
            items.append([row // tiles, row % tiles, k0, count, -1])
            pos += count
        first.append(len(items))
    merges, slots, i = [], 0, 0
    while i < len(items):  # a query tile's items are consecutive
        j = i + 1
        while j < len(items) and items[j][:2] == items[i][:2]:
            j += 1
        if j - i > 1:
            merges.append((items[i][0], items[i][1], slots, j - i))
            for item in items[i:j]:
                item[4] = slots
                slots += 1
        i = j
    return AttentionPlan(tuple(map(tuple, items)), tuple(first), tuple(merges), slots,
                         len(merges))


@functools.lru_cache(maxsize=None)
def _attention_plan_on(batch: int, n: int, device: torch.device):
    """``cached_attention_plan`` for ``device``'s SMs and as the kernel reads
    it (made once a shape: read-only tables): the plan, items [I, 8],
    first [blocks + 1] and merges [M, 4] int32 on ``device``."""
    plan = cached_attention_plan(batch, n,
                                 torch.cuda.get_device_properties(device).multi_processor_count)
    items = [list(item) + [0, 0, 0] for item in plan.items]
    return (plan, torch.tensor(items, dtype=torch.int32, device=device),
            torch.tensor(plan.first, dtype=torch.int32, device=device),
            torch.tensor(plan.merges or [(0, 0, 0, 0)], dtype=torch.int32, device=device))


def _launch_sc_attention(q, k, v, compat, key_bias, c):
    """q, k, v bf16 [B, N, W] (W = ``padded_width(c)``), contiguous; c the
    model's width. W = 128: the kernel of sc_attention_cached.cu on the
    shape's plan (its split query tiles merged by a second launch); wider:
    sc_attention.cu's wide kernel."""
    b, n, w = q.shape
    out = torch.empty((b, n, w), dtype=torch.float32, device=q.device)
    if w != ATTN_WIDTH:
        _build.launch("sc_attention", "sc_attention_cached_wide", q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), compat.data_ptr(),
                      key_bias.data_ptr(), out.data_ptr(), b, n, w, qk_scale(c))
        return out
    plan, items, first, merges = _attention_plan_on(b, n, q.device)
    fused_sc_attention_cached.plan = plan
    part = torch.empty(max(plan.slots, 1) * (ATTN_ROWS * ATTN_WIDTH + 2 * ATTN_ROWS),
                       dtype=torch.float32, device=q.device)
    _build.launch("sc_attention_cached", "sc_attention_cached128", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), compat.data_ptr(),
                  key_bias.data_ptr(), out.data_ptr(), part.data_ptr(), items.data_ptr(),
                  first.data_ptr(), merges.data_ptr(), len(plan.first) - 1, len(plan.merges),
                  plan.slots, b, n, qk_scale(c))
    return out


def offset_attention_math(q, k, v, compat, bias, kscale, round_p: bool, c=None):
    """The offset softmax on f32 q, k, v [B, N, C]: offset_i = ||q_i|| *
    kscale (kscale [B]), p = exp(max(compat * (q k^T * scale) + bias -
    offset, -80)), zero where bias < 0 (``bias`` [B, N] or None), the sum of p
    in f32, p rounded to bf16 before p v when ``round_p``, acc / (l + 1e-30).
    Shared by the plain versions of the offset attention kernel and of the
    encoder-layer kernels (kernels/encoder_layer.py). ``c``: as in
    ``sc_attention_cached_plain``."""
    scale = torch.tensor(qk_scale(c or q.shape[-1]), dtype=torch.float32, device=q.device)
    offset = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) * kscale[:, None, None]
    s = compat.float() * (torch.einsum("bnc,bmc->bnm", q, k) * scale)
    if bias is not None:
        s = s + bias[:, None, :]
    p = torch.exp(torch.clamp(s - offset, min=-80.0))
    if bias is not None:
        p = torch.where(bias[:, None, :] < 0.0, torch.zeros_like(p), p)
    l = torch.sum(p, dim=-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).float()
    return torch.einsum("bnm,bmc->bnc", p, v) / (l + 1e-30)


def offset_kscale(k, c=None):
    """max_j ||k_j|| / sqrt(C) per pair, [B] f32, left on k's device (the
    kernel reads it by pointer, so no host read sits between the layers).
    ``c``: as in ``sc_attention_cached_plain``."""
    k = k.float()
    kmax = torch.sqrt(torch.amax(torch.sum(k * k, dim=-1), dim=-1))
    return kmax / float(np.float32((c or k.shape[-1]) ** 0.5))


def sc_attention_cached_offset_plain(q, k, v, compat, key_bias, c=None):
    """Plain version of the offset attention kernel on the same inputs: q, k,
    v f32, or bf16, and then p is rounded to bf16 before p v. ``c``: as in
    ``sc_attention_cached_plain``."""
    return offset_attention_math(q.float(), k.float(), v.float(), compat, key_bias,
                                 offset_kscale(k, c), round_p=q.dtype == torch.bfloat16, c=c)


def _launch_sc_attention_offset(q, k, v, compat, key_bias, c):
    """q, k, v bf16 [B, N, W] (W = ``padded_width(c)``), contiguous; c the
    model's width."""
    b, n, w = q.shape
    out = torch.empty((b, n, w), dtype=torch.float32, device=q.device)
    kscale = offset_kscale(k, c)  # alive until the launch is enqueued
    _build.launch("sc_attention", "sc_attention_cached_offset", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), compat.data_ptr(),
                  key_bias.data_ptr(), kscale.data_ptr(), out.data_ptr(), b, n, w, qk_scale(c))
    return out


def _expect_qkv(q, k, v, rect: bool = False) -> None:
    """q, k, v [B, N, C], all float32 or all bfloat16, on one device; with
    ``rect``, q [B, Nq, C] and k, v [B, Nk, C]."""
    expect(q, "q", ndim=3)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    shape = (q.shape[0], k.shape[1], q.shape[2]) if rect else q.shape
    for name, t in (("k", k), ("v", v)):
        expect(t, name, dtype=q.dtype, shape=shape, device=q.device)


def _kernel_operands(q, k, v):
    """q, k, v as the bf16 attention kernels take them on the card: rounded
    to bf16 as the JAX wrappers round them off the CPU (``use_bf16=True``),
    zero-padded to a multiple of 128 channels, 16-byte aligned."""
    check_width(q.shape[-1], "the attention kernels")
    q, k, v = (pad_channels(t.bfloat16()) for t in (q, k, v))
    expect_aligned({"q": q, "k": k, "v": v})
    return q, k, v


def _launch_sc_attention_rect(q, k, v, compat, key_bias, c, offset_softmax):
    """q bf16 [B, Nq, W], k, v bf16 [B, Nk, W] (W = ``padded_width(c)``),
    compat int8 [B, Nq, Nk], contiguous; c the model's width."""
    b, nq, w = q.shape
    nk = k.shape[1]
    out = torch.empty((b, nq, w), dtype=torch.float32, device=q.device)
    # the offset's bound over all nk keys, alive until the launch is enqueued
    # (the running max reads none: the bias row stands in for the pointer)
    kscale = offset_kscale(k, c) if offset_softmax else key_bias
    _build.launch("sc_attention", "sc_attention_cached_rect", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), compat.data_ptr(), key_bias.data_ptr(),
                  kscale.data_ptr(), out.data_ptr(), b, nq, nk, w, qk_scale(c),
                  0 if offset_softmax else 1)
    return out


def fused_sc_attention_cached(q, k, v, compat, src, tgt, mask=None, offset_softmax=True):
    """Attention over the int8 cache: q, k, v [B, N, C], compat [B, N, N]
    int8, src/tgt/mask only for the key-bias row. Returns [B, N, C] f32.

    A row shard (the sequence-parallel encoder's, JAX's rectangular form):
    q [B, Nq, C] over k, v [B, Nk, C] with Nq != Nk, compat the shard's
    [B, Nq, Nk] slice, src/tgt [B, Nk, 3] and mask [B, Nk] those of the
    keys; on the card the rectangular kernel of the same form, the offset's
    bound taken over all Nk keys.
    ``offset_softmax=True`` (the JAX default) runs the offset kernel, exact
    while the bound's slack stays inside the regime of models/regime.py;
    ``False`` the running-max kernel, exact for any weights.

    q, k, v are f32, or all bf16 (the half-precision encoder). Both kernels
    take bf16 and round p to bf16 before p v, as the TPU kernels round it to
    their v's type: on a CUDA tensor f32 inputs are rounded to bf16, as the
    JAX wrapper rounds them off the CPU (``use_bf16=True``; on the CPU they
    stay f32, there as here). The kernels take any C (zero-padded to a
    multiple of 128; above 128 one pass per 128-wide output chunk) and any
    N."""
    b, nq, c = q.shape
    n = k.shape[1]
    rect = n != nq
    _expect_qkv(q, k, v, rect)
    expect(compat, "compat", dtype=torch.int8, shape=(b, nq, n), device=q.device)
    expect(src, "src", shape=(b, n, 3), device=q.device)
    expect(tgt, "tgt", shape=(b, n, 3), device=q.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=(b, n), device=q.device)
    bias = key_bias(mask, b, n, q.device)
    if not on_cuda(q):
        if offset_softmax:
            return sc_attention_cached_offset_plain(q, k, v, compat, bias)
        return sc_attention_cached_plain(q, k, v, compat, bias)
    q, k, v = _kernel_operands(q, k, v)
    if rect:
        counter = sc_attention_cached_offset if offset_softmax else fused_sc_attention_cached
        counter.launches += 1
        return unpad_channels(_launch_sc_attention_rect(q, k, v, compat, bias, c,
                                                        offset_softmax), c)
    if offset_softmax:
        sc_attention_cached_offset.launches += 1
        return unpad_channels(_launch_sc_attention_offset(q, k, v, compat, bias, c), c)
    fused_sc_attention_cached.launches += 1
    return unpad_channels(_launch_sc_attention(q, k, v, compat, bias, c), c)


def sc_attention_cached_offset(q, k, v, compat, src, tgt, mask=None):
    """``fused_sc_attention_cached(offset_softmax=True)``: the name that
    carries the offset kernel's launch count."""
    return fused_sc_attention_cached(q, k, v, compat, src, tgt, mask=mask, offset_softmax=True)


# launches of the running-max kernel and of the offset kernel; the running
# max's last plan at C = 128 (its ``splits``: the query tiles it merged)
fused_sc_attention_cached.launches = 0
sc_attention_cached_offset.launches = 0
fused_sc_attention_cached.plan = None


# ---------------------------------------------------------------------------
# Attention from the geometry, no cache: forward (with the row LSE), backward


def sigma_d_sq(sigma_d: float) -> float:
    """sigma_d^2 evaluated in float32, as the TPU kernel does."""
    sig = np.float32(sigma_d)
    return float(sig * sig)


def compat_from_geometry(geom: torch.Tensor, sig2: float) -> torch.Tensor:
    """[B, N, N] compat = max(1 - (d_src - d_tgt)^2 / sigma_d^2, 0) from the
    packed strip, distances in the JAX kernel's form sqrt(max(|a|^2 + |b|^2
    - 2 a.b, 0)) on the packed squared norms. The 3-term inner product is
    written out elementwise, each operation rounded once: the CUDA kernel
    evaluates the same sequence, so both see the same compat bit for bit."""
    def dist(g):  # rows x, y, z, squared norm
        inner = (g[:, 0, :, None] * g[:, 0, None, :] + g[:, 1, :, None] * g[:, 1, None, :]
                 + g[:, 2, :, None] * g[:, 2, None, :])
        d2 = (g[:, 3, :, None] + g[:, 3, None, :]) - 2.0 * inner
        return torch.sqrt(torch.clamp(d2, min=0.0))

    diff = dist(geom[:, 0:4]) - dist(geom[:, 4:8])
    # a tensor divisor: by a Python scalar PyTorch multiplies by the reciprocal
    return torch.clamp(1.0 - diff * diff / geom.new_tensor(sig2), min=0.0)


def _geometry_softmax(q, k, v, geom, sigma_d, round_p: bool, c=None):
    """(out, m, l) of s = compat * (q k^T / sqrt(C)) + bias with m clamped at
    -1e9, p = exp(s - m), l = sum p, out = p v / (l + 1e-30); p rounded to
    bf16 before p v when ``round_p`` (l from the unrounded p). ``c``: as in
    ``sc_attention_cached_plain``."""
    compat = compat_from_geometry(geom, sigma_d_sq(sigma_d))
    s = compat * (torch.einsum("bnc,bmc->bnm", q, k) * inv_sqrt_c(c or q.shape[-1])) \
        + geom[:, 8][:, None, :]
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=_NEG)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).to(p.dtype)
    return torch.einsum("bnm,bmc->bnc", p, v) / (l + 1e-30), m, l


def sc_attention_forward_plain(q, k, v, geom, sigma_d, c=None):
    """Plain version of the forward kernel: (out [B, N, C], lse [B, N]) with
    s = compat * (q k^T / sqrt(C)) + bias, m clamped at -1e9,
    out = p v / (l + 1e-30), lse = m + log(l + 1e-30). ``c``: as in
    ``sc_attention_cached_plain``."""
    out, m, l = _geometry_softmax(q, k, v, geom, sigma_d, round_p=False, c=c)
    return out, (m + torch.log(l + 1e-30))[..., 0]


def sc_attention_nocache_plain(q, k, v, geom, sigma_d, c=None):
    """Plain version of the no-cache eval attention kernel, out [B, N, C] f32.
    q, k, v f32: ``sc_attention_forward_plain``'s out. bf16: the products run
    in f32 on the bf16 values and p is rounded to bf16 before p v, with l
    summed from the unrounded p (``sc_attention_cached_plain``'s rule).
    ``c``: as in ``sc_attention_cached_plain``."""
    round_p = q.dtype == torch.bfloat16
    return _geometry_softmax(q.float(), k.float(), v.float(), geom, sigma_d, round_p, c)[0]


def sc_attention_backward_plain(q, k, v, geom, lse, dvec, d_out, sigma_d, c=None):
    """Plain version of the two backward kernels: (dq, dk, dv) from the saved
    LSE, with P = exp(s - lse), dS = P (dO V^T - D), dlogits = dS * compat /
    sqrt(C). ``dvec`` [B, N] is D = rowsum(dO * O). ``c``: as in
    ``sc_attention_cached_plain``."""
    scale = inv_sqrt_c(c or q.shape[-1])
    compat = compat_from_geometry(geom, sigma_d_sq(sigma_d))
    s = compat * (torch.einsum("bnc,bmc->bnm", q, k) * scale) + geom[:, 8][:, None, :]
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bnc,bmc->bnm", d_out, v)
    dlogits = p * (dp - dvec[..., None]) * compat * scale
    dq = torch.einsum("bnm,bmc->bnc", dlogits, k)
    dk = torch.einsum("bnm,bnc->bmc", dlogits, q)
    dv = torch.einsum("bnm,bnc->bmc", p, d_out)
    return dq, dk, dv


# f32 operations per (query, key) pair beside the C-term products, counted
# from csrc/compat_geom.cuh and csrc/sc_attention_train.cu
OPS_PER_COMPAT_PAIR = 25  # two 3-dots (10), two gram distances (10), diff, square, divide, 1 -, max
OPS_PER_FWD_PAIR_EXTRA = 8  # scale, compat multiply, bias add, max, exp, sum
OPS_PER_BWD_PAIR_EXTRA = 9  # scale, compat multiply, bias, - lse, exp, dP - D, 3 multiplies


def train_attention_work(bs: int, n: int, c: int = 128) -> dict:
    """The least work of the trainable attention's three kernels on a batch of
    bs samples of n points at width c: {"forward", "dq", "dkv"} -> (bytes,
    operations). Bytes: each [N, C] operand read once and each output written
    once (q, k, v, out for the forward; q, k, v, dO, dQ; q, k, v, dO, dK, dV),
    the 16-row geometry strip, the lse written or read and D read.
    Operations: 2 C per pair for each C-term product (s, and dP, P V, dQ, dK,
    dV), and the compat entry and softmax work of every pair."""
    act, vec = bs * n * c * 4, bs * n * 4
    geom, pairs = 16 * vec, float(bs) * n * n
    extra_f = OPS_PER_COMPAT_PAIR + OPS_PER_FWD_PAIR_EXTRA
    extra_b = OPS_PER_COMPAT_PAIR + OPS_PER_BWD_PAIR_EXTRA
    return {"forward": (4 * act + geom + vec, pairs * (4 * c + extra_f)),
            "dq": (5 * act + geom + 2 * vec, pairs * (6 * c + extra_b)),
            "dkv": (6 * act + geom + 2 * vec, pairs * (8 * c + extra_b))}


def _check_qkv_geom(q, k, v, geom):
    """Shapes of the no-cache kernels' inputs; float32 on a CUDA tensor (the
    plain versions also take float64, for gradient checks)."""
    expect(q, "q", ndim=3)
    cuda = on_cuda(q)
    dtype = torch.float32 if cuda else q.dtype
    for name, t in (("q", q), ("k", k), ("v", v)):
        expect(t, name, dtype=dtype, shape=q.shape, device=q.device)
    b, n, c = q.shape
    expect(geom, "geom", dtype=dtype, shape=(b, 16, n), device=q.device)
    if cuda:
        check_width(c, "the attention kernels")
    return cuda


def sc_attention_forward(q, k, v, geom, sigma_d):
    """Forward of the trainable attention: q, k, v [B, N, C] f32, geom
    [B, 16, N] (``pack_geometry``) -> (out [B, N, C], lse [B, N]). On the
    card any C, zero-padded to a multiple of 128."""
    if not _check_qkv_geom(q, k, v, geom):
        return sc_attention_forward_plain(q, k, v, geom, sigma_d)
    b, n, c = q.shape
    q, k, v = (pad_channels(t) for t in (q, k, v))
    w = q.shape[-1]
    out = torch.empty((b, n, w), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    sc_attention_forward.launches += 1
    _build.launch("sc_attention_train", "sc_attention_train_fwd", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), geom.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), b, n, w, sigma_d_sq(sigma_d), inv_sqrt_c(c))
    return unpad_channels(out, c), lse


def _check_backward(q, k, v, geom, lse, dvec, d_out):
    cuda = _check_qkv_geom(q, k, v, geom)
    expect(d_out, "d_out", dtype=q.dtype, shape=q.shape, device=q.device)
    for name, t in (("lse", lse), ("dvec", dvec)):
        expect(t, name, dtype=q.dtype, shape=q.shape[:2], device=q.device)
    return cuda


def sc_attention_backward_dq(q, k, v, geom, lse, dvec, d_out, sigma_d):
    """dQ [B, N, C] of the trainable attention (a key loop per query tile)."""
    if not _check_backward(q, k, v, geom, lse, dvec, d_out):
        return sc_attention_backward_plain(q, k, v, geom, lse, dvec, d_out, sigma_d)[0]
    b, n, c = q.shape
    q, k, v, d_out = (pad_channels(t) for t in (q, k, v, d_out))
    dq = torch.empty_like(q)
    sc_attention_backward_dq.launches += 1
    _build.launch("sc_attention_train", "sc_attention_train_bwd_dq", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), geom.data_ptr(),
                  lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), b, n, q.shape[-1],
                  sigma_d_sq(sigma_d), inv_sqrt_c(c))
    return unpad_channels(dq, c)


def sc_attention_backward_dkv(q, k, v, geom, lse, dvec, d_out, sigma_d):
    """(dK, dV) of the trainable attention (a query loop per key tile)."""
    if not _check_backward(q, k, v, geom, lse, dvec, d_out):
        return sc_attention_backward_plain(q, k, v, geom, lse, dvec, d_out, sigma_d)[1:]
    b, n, c = q.shape
    q, k, v, d_out = (pad_channels(t) for t in (q, k, v, d_out))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sc_attention_backward_dkv.launches += 1
    _build.launch("sc_attention_train", "sc_attention_train_bwd_dkv", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), geom.data_ptr(),
                  lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n,
                  q.shape[-1], sigma_d_sq(sigma_d), inv_sqrt_c(c))
    return unpad_channels(dk, c), unpad_channels(dv, c)


class _SCAttentionTrainable(torch.autograd.Function):
    """Forward saves (q, k, v, geom, lse, out); backward recomputes P from the
    LSE tile by tile. Geometry has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, geom, sigma_d):
        q, k, v, geom = q.contiguous(), k.contiguous(), v.contiguous(), geom.contiguous()
        out, lse = sc_attention_forward(q, k, v, geom, sigma_d)
        ctx.save_for_backward(q, k, v, geom, lse, out)
        ctx.sigma_d = sigma_d
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, geom, lse, out = ctx.saved_tensors
        d_out = d_out.contiguous()
        dvec = torch.sum(d_out * out, dim=-1)
        args = (q, k, v, geom, lse, dvec, d_out, ctx.sigma_d)
        if on_cuda(q):
            dq = sc_attention_backward_dq(*args)
            dk, dv = sc_attention_backward_dkv(*args)
        else:  # one pass of the plain version gives all three
            dq, dk, dv = sc_attention_backward_plain(*args)
        return dq, dk, dv, None, None


def sc_attention_trainable(q, k, v, geom, sigma_d: float):
    """Differentiable attention from the geometry: q, k, v [B, N, C] f32, geom
    [B, 16, N] from ``pack_geometry`` -> [B, N, C]. Gradients reach q, k, v."""
    return _SCAttentionTrainable.apply(q, k, v, geom, sigma_d)


def _launch_sc_attention_nocache(q, k, v, geom, sigma_d, c):
    """q, k, v bf16 [B, N, W] (W = ``padded_width(c)``), contiguous; geom
    [B, 16, N] f32; c the model's width."""
    b, n, w = q.shape
    out = torch.empty((b, n, w), dtype=torch.float32, device=q.device)
    _build.launch("sc_attention", "sc_attention_nocache", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), geom.data_ptr(), out.data_ptr(),
                  b, n, w, sigma_d_sq(sigma_d), inv_sqrt_c(c))
    return out


def fused_sc_attention(q, k, v, src, tgt, sigma_d: float, mask=None):
    """Eval attention without a cache: q, k, v [B, N, C] (f32, or all bf16),
    src/tgt [B, N, 3] -> [B, N, C] f32, the compat tile computed from the
    geometry. On a CUDA tensor q, k, v are rounded to bf16, as the JAX
    wrapper rounds them off the CPU (``use_bf16=True``), and the running-max
    kernel of the cached attention runs with its geometry compat source,
    rounding p to bf16 before p v as the TPU kernel rounds it to its v's
    type; on the CPU they keep their type, as in JAX's interpret mode (f32:
    the trainable forward's out). The kernel takes any C (zero-padded to a
    multiple of 128) and any N."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    _expect_qkv(q, k, v)
    expect(src, "src", shape=(*q.shape[:2], 3), device=q.device)
    expect(tgt, "tgt", shape=src.shape, device=q.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=q.shape[:2], device=q.device)
    geom = pack_geometry(src, tgt, mask)
    if not on_cuda(q):
        return sc_attention_nocache_plain(q, k, v, geom, sigma_d)
    c = q.shape[-1]
    q, k, v = _kernel_operands(q, k, v)
    fused_sc_attention.launches += 1
    return unpad_channels(_launch_sc_attention_nocache(q, k, v, geom, sigma_d, c), c)


sc_attention_forward.launches = 0
sc_attention_backward_dq.launches = 0
sc_attention_backward_dkv.launches = 0
fused_sc_attention.launches = 0
