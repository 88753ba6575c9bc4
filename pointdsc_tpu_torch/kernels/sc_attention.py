"""Spatial-consistency attention kernels (PyTorch wrappers of
``csrc/compat_cache.cu``, ``csrc/sc_attention.cu`` and
``csrc/sc_attention_train.cu``; counterparts of
``pointdsc_tpu/kernels/sc_attention.py``).

Eval: the 12 encoder layers share one compat matrix, built once as int8
(value = round(127 * compat)); each layer streams it through the offset or
the running-max attention kernel. Without a cache (``fused_sc_attention``,
the running-max kernel on bf16 operands) and in training
(``sc_attention_trainable``, a ``torch.autograd.Function`` with an f32
forward kernel that saves the row LSE and two backward kernels) the compat
tile is recomputed from the packed geometry, so nothing [N, N] exists in
either pass. On a CPU tensor each wrapper runs its plain PyTorch version;
on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

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


def compat_cache_plain(geom: torch.Tensor, coef: float) -> torch.Tensor:
    """Plain version of the cache kernel: gram-form distances, one-sqrt
    difference, round(max(127 - coef * diff2, 0)) clamped at 127."""
    gs, gt = geom[:, 0:3], geom[:, 4:7]
    inner_s = gs.transpose(1, 2) @ gs
    inner_t = gt.transpose(1, 2) @ gt
    s2 = torch.clamp(geom[:, 3, :, None] + geom[:, 3, None, :] - 2.0 * inner_s, min=0.0)
    t2 = torch.clamp(geom[:, 7, :, None] + geom[:, 7, None, :] - 2.0 * inner_t, min=0.0)
    diff2 = s2 + t2 - 2.0 * torch.sqrt(s2 * t2)
    scaled = 127.0 - diff2 * torch.tensor(coef, dtype=torch.float32, device=geom.device)
    return torch.clamp(torch.round(torch.clamp(scaled, min=0.0)), max=127.0).to(torch.int8)


def _launch_compat_cache(src: torch.Tensor, tgt: torch.Tensor, coef: float) -> torch.Tensor:
    """src, tgt f32 [B, N, 3], contiguous: the whole cache in one launch,
    the squared norms computed by the kernel (no packed strip)."""
    b, n, _ = src.shape
    out = torch.empty((b, n, n), dtype=torch.int8, device=src.device)
    _build.launch("compat_cache", "compat_cache_int8", src.device,
                  src.data_ptr(), tgt.data_ptr(), out.data_ptr(), b, n, coef)
    return out


def build_compat_cache_int8(src: torch.Tensor, tgt: torch.Tensor, sigma_d: float,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, N, N] int8 cache of round(127 * compat) from src/tgt [B, N, 3].
    Nothing is masked: the attention's key bias handles invalid keys (the
    mask is checked and otherwise unused). On the card one launch reads src
    and tgt in place."""
    expect(src, "src", ndim=3, last=3)
    expect(tgt, "tgt", shape=src.shape, device=src.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=src.device)
    coef = cache_coef(sigma_d)
    if not on_cuda(src):
        return compat_cache_plain(pack_geometry(src, tgt, mask), coef)
    build_compat_cache_int8.launches += 1
    return _launch_compat_cache(src.float(), tgt.float(), coef)


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


def _launch_sc_attention(q, k, v, compat, key_bias, c):
    """q, k, v bf16 [B, N, W] (W = ``padded_width(c)``), contiguous; c the
    model's width."""
    b, n, w = q.shape
    out = torch.empty((b, n, w), dtype=torch.float32, device=q.device)
    _build.launch("sc_attention", "sc_attention_cached", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), compat.data_ptr(),
                  key_bias.data_ptr(), out.data_ptr(), b, n, w, qk_scale(c))
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


def _expect_qkv(q, k, v) -> None:
    """q, k, v [B, N, C], all float32 or all bfloat16, on one device."""
    expect(q, "q", ndim=3)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        expect(t, name, dtype=q.dtype, shape=q.shape, device=q.device)


def _kernel_operands(q, k, v):
    """q, k, v as the bf16 attention kernels take them on the card: rounded
    to bf16 as the JAX wrappers round them off the CPU (``use_bf16=True``),
    zero-padded to a multiple of 128 channels, 16-byte aligned."""
    check_width(q.shape[-1], "the attention kernels")
    q, k, v = (pad_channels(t.bfloat16()) for t in (q, k, v))
    expect_aligned({"q": q, "k": k, "v": v})
    return q, k, v


def fused_sc_attention_cached(q, k, v, compat, src, tgt, mask=None, offset_softmax=True):
    """Attention over the int8 cache: q, k, v [B, N, C], compat [B, N, N]
    int8, src/tgt/mask only for the key-bias row. Returns [B, N, C] f32.
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
    _expect_qkv(q, k, v)
    b, n, c = q.shape
    expect(compat, "compat", dtype=torch.int8, shape=(b, n, n), device=q.device)
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
    if offset_softmax:
        sc_attention_cached_offset.launches += 1
        return unpad_channels(_launch_sc_attention_offset(q, k, v, compat, bias, c), c)
    fused_sc_attention_cached.launches += 1
    return unpad_channels(_launch_sc_attention(q, k, v, compat, bias, c), c)


def sc_attention_cached_offset(q, k, v, compat, src, tgt, mask=None):
    """``fused_sc_attention_cached(offset_softmax=True)``: the name that
    carries the offset kernel's launch count."""
    return fused_sc_attention_cached(q, k, v, compat, src, tgt, mask=mask, offset_softmax=True)


# launches of the running-max kernel and of the offset kernel
fused_sc_attention_cached.launches = 0
sc_attention_cached_offset.launches = 0


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
