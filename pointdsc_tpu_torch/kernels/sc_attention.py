"""Spatial-consistency attention kernels (PyTorch wrappers of
``csrc/compat_cache.cu``, ``csrc/sc_attention.cu`` and
``csrc/sc_attention_train.cu``; counterparts of
``pointdsc_tpu/kernels/sc_attention.py``).

Eval: the 12 encoder layers share one compat matrix, built once as int8
(value = round(127 * compat)); each layer streams it through the offset or
the running-max attention kernel. Without a cache (``fused_sc_attention``)
and in training (``sc_attention_trainable``, a ``torch.autograd.Function``
with a forward kernel that saves the row LSE and two backward kernels) the
compat tile is recomputed from the packed geometry, so nothing [N, N] exists
in either pass. On a CPU tensor each wrapper runs its plain PyTorch version;
on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda

_NEG = -1e9
C_KERNEL = 128  # the attention kernel's compiled channel width


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


def _launch_compat_cache(geom: torch.Tensor, coef: float) -> torch.Tensor:
    b, _, n = geom.shape
    out = torch.empty((b, n, n), dtype=torch.int8, device=geom.device)
    _build.launch("compat_cache", "compat_cache_int8", geom.device,
                  geom.data_ptr(), out.data_ptr(), b, n, coef)
    return out


def build_compat_cache_int8(src: torch.Tensor, tgt: torch.Tensor, sigma_d: float,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, N, N] int8 cache of round(127 * compat) from src/tgt [B, N, 3].
    Nothing is masked: the attention's key bias handles invalid keys."""
    expect(src, "src", ndim=3, last=3)
    expect(tgt, "tgt", shape=src.shape, device=src.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=src.device)
    geom = pack_geometry(src, tgt, mask)
    coef = cache_coef(sigma_d)
    if not on_cuda(geom):
        return compat_cache_plain(geom, coef)
    build_compat_cache_int8.launches += 1
    return _launch_compat_cache(geom, coef)


build_compat_cache_int8.launches = 0


def inv_sqrt_c(c: int) -> float:
    """1/sqrt(C) rounded once to float32, as JAX rounds the Python constant."""
    return float(np.float32(1.0 / (c ** 0.5)))


def qk_scale(c: int) -> float:
    """1/sqrt(C)/127 rounded once to float32 (as JAX rounds the Python
    constant): the int8 decode folded into the qk scale."""
    return float(np.float32(1.0 / (c ** 0.5) / 127.0))


def sc_attention_cached_plain(q, k, v, compat, key_bias):
    """Plain version of the attention kernel on the same inputs:
    softmax(compat * (q k^T * scale) + bias) v with the kernel's
    acc / (l + 1e-30) normalisation."""
    scale = torch.tensor(qk_scale(q.shape[-1]), dtype=torch.float32, device=q.device)
    logits = torch.einsum("bnc,bmc->bnm", q, k) * scale
    s = compat.float() * logits + key_bias[:, None, :]
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=_NEG)
    p = torch.exp(s - m)
    return torch.einsum("bnm,bmc->bnc", p, v) / (torch.sum(p, dim=-1, keepdim=True) + 1e-30)


def _launch_sc_attention(q, k, v, compat, key_bias):
    b, n, c = q.shape
    out = torch.empty((b, n, c), dtype=torch.float32, device=q.device)
    _build.launch("sc_attention", "sc_attention_cached", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), compat.data_ptr(),
                  key_bias.data_ptr(), out.data_ptr(), b, n, qk_scale(c))
    return out


def offset_attention_math(q, k, v, compat, bias, kscale, round_p: bool):
    """The offset softmax on f32 q, k, v [B, N, C]: offset_i = ||q_i|| *
    kscale (kscale [B]), p = exp(max(compat * (q k^T * scale) + bias -
    offset, -80)), zero where bias < 0 (``bias`` [B, N] or None), the sum of p
    in f32, p rounded to bf16 before p v when ``round_p``, acc / (l + 1e-30).
    Shared by the plain versions of the offset attention kernel and of the
    encoder-layer kernels (kernels/encoder_layer.py)."""
    scale = torch.tensor(qk_scale(q.shape[-1]), dtype=torch.float32, device=q.device)
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


def offset_kscale(k):
    """max_j ||k_j|| / sqrt(C) per pair, [B] f32, left on k's device (the
    kernel reads it by pointer, so no host read sits between the layers)."""
    k = k.float()
    kmax = torch.sqrt(torch.amax(torch.sum(k * k, dim=-1), dim=-1))
    return kmax / float(np.float32(k.shape[-1] ** 0.5))


def sc_attention_cached_offset_plain(q, k, v, compat, key_bias):
    """Plain version of the offset attention kernel on the same inputs: q, k,
    v f32, or bf16, and then p is rounded to bf16 before p v."""
    return offset_attention_math(q.float(), k.float(), v.float(), compat, key_bias,
                                 offset_kscale(k), round_p=q.dtype == torch.bfloat16)


def _launch_sc_attention_offset(q, k, v, compat, key_bias):
    """q, k, v bf16, contiguous."""
    b, n, c = q.shape
    out = torch.empty((b, n, c), dtype=torch.float32, device=q.device)
    kscale = offset_kscale(k)  # alive until the launch is enqueued
    _build.launch("sc_attention", "sc_attention_cached_offset", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), compat.data_ptr(),
                  key_bias.data_ptr(), kscale.data_ptr(), out.data_ptr(), b, n, qk_scale(c))
    return out


def fused_sc_attention_cached(q, k, v, compat, src, tgt, mask=None, offset_softmax=True):
    """Attention over the int8 cache: q, k, v [B, N, C], compat [B, N, N]
    int8, src/tgt/mask only for the key-bias row. Returns [B, N, C] f32.
    ``offset_softmax=True`` (the JAX default) runs the offset kernel, exact
    while the bound's slack stays inside the regime of models/regime.py;
    ``False`` the running-max kernel, exact for any weights.

    q, k, v are f32, or all bf16 (the half-precision encoder). The offset
    kernel takes bf16 and rounds p to bf16 before p v, as the TPU kernel
    rounds it to its v's type: on a CUDA tensor f32 inputs are rounded to bf16
    for it, as the JAX wrapper rounds them off the CPU (on the CPU they stay
    f32, there as here). The running-max kernel takes f32, so bf16 inputs are
    widened for it. The kernels take C = 128 and any N."""
    expect(q, "q", ndim=3)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        expect(t, name, dtype=q.dtype, shape=q.shape, device=q.device)
    b, n, c = q.shape
    expect(compat, "compat", dtype=torch.int8, shape=(b, n, n), device=q.device)
    expect(src, "src", shape=(b, n, 3), device=q.device)
    expect(tgt, "tgt", shape=(b, n, 3), device=q.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=(b, n), device=q.device)
    bias = key_bias(mask, b, n, q.device)
    if not offset_softmax:
        q, k, v = q.float(), k.float(), v.float()
    if not on_cuda(q):
        if offset_softmax:
            return sc_attention_cached_offset_plain(q, k, v, compat, bias)
        return sc_attention_cached_plain(q, k, v, compat, bias)
    if c != C_KERNEL:
        raise ValueError(f"the attention kernels take C={C_KERNEL}, got C={c}")
    if offset_softmax:
        sc_attention_cached_offset.launches += 1
        return _launch_sc_attention_offset(q.bfloat16(), k.bfloat16(), v.bfloat16(), compat, bias)
    fused_sc_attention_cached.launches += 1
    return _launch_sc_attention(q, k, v, compat, bias)


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


def sc_attention_forward_plain(q, k, v, geom, sigma_d):
    """Plain version of the forward kernel: (out [B, N, C], lse [B, N]) with
    s = compat * (q k^T / sqrt(C)) + bias, m clamped at -1e9,
    out = p v / (l + 1e-30), lse = m + log(l + 1e-30)."""
    compat = compat_from_geometry(geom, sigma_d_sq(sigma_d))
    s = compat * (torch.einsum("bnc,bmc->bnm", q, k) * inv_sqrt_c(q.shape[-1])) \
        + geom[:, 8][:, None, :]
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=_NEG)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bnm,bmc->bnc", p, v) / (l + 1e-30)
    return out, (m + torch.log(l + 1e-30))[..., 0]


def sc_attention_backward_plain(q, k, v, geom, lse, dvec, d_out, sigma_d):
    """Plain version of the two backward kernels: (dq, dk, dv) from the saved
    LSE, with P = exp(s - lse), dS = P (dO V^T - D), dlogits = dS * compat /
    sqrt(C). ``dvec`` [B, N] is D = rowsum(dO * O)."""
    scale = inv_sqrt_c(q.shape[-1])
    compat = compat_from_geometry(geom, sigma_d_sq(sigma_d))
    s = compat * (torch.einsum("bnc,bmc->bnm", q, k) * scale) + geom[:, 8][:, None, :]
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bnc,bmc->bnm", d_out, v)
    dlogits = p * (dp - dvec[..., None]) * compat * scale
    dq = torch.einsum("bnm,bmc->bnc", dlogits, k)
    dk = torch.einsum("bnm,bnc->bmc", dlogits, q)
    dv = torch.einsum("bnm,bnc->bmc", p, d_out)
    return dq, dk, dv


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
    if cuda and c != C_KERNEL:
        raise ValueError(f"the attention kernels take C={C_KERNEL}, got C={c}")
    return cuda


def _launch_forward(q, k, v, geom, sigma_d, with_lse: bool):
    b, n, c = q.shape
    out = torch.empty((b, n, c), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device) if with_lse else None
    _build.launch("sc_attention_train", "sc_attention_train_fwd", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), geom.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if with_lse else None, b, n, sigma_d_sq(sigma_d),
                  inv_sqrt_c(c))
    return out, lse


def sc_attention_forward(q, k, v, geom, sigma_d):
    """Forward of the trainable attention: q, k, v [B, N, C] f32, geom
    [B, 16, N] (``pack_geometry``) -> (out [B, N, C], lse [B, N])."""
    if not _check_qkv_geom(q, k, v, geom):
        return sc_attention_forward_plain(q, k, v, geom, sigma_d)
    sc_attention_forward.launches += 1
    return _launch_forward(q, k, v, geom, sigma_d, with_lse=True)


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
    dq = torch.empty_like(q)
    sc_attention_backward_dq.launches += 1
    _build.launch("sc_attention_train", "sc_attention_train_bwd_dq", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), geom.data_ptr(),
                  lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), b, n, sigma_d_sq(sigma_d),
                  inv_sqrt_c(c))
    return dq


def sc_attention_backward_dkv(q, k, v, geom, lse, dvec, d_out, sigma_d):
    """(dK, dV) of the trainable attention (a query loop per key tile)."""
    if not _check_backward(q, k, v, geom, lse, dvec, d_out):
        return sc_attention_backward_plain(q, k, v, geom, lse, dvec, d_out, sigma_d)[1:]
    b, n, c = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sc_attention_backward_dkv.launches += 1
    _build.launch("sc_attention_train", "sc_attention_train_bwd_dkv", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), geom.data_ptr(),
                  lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n,
                  sigma_d_sq(sigma_d), inv_sqrt_c(c))
    return dk, dv


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


def fused_sc_attention(q, k, v, src, tgt, sigma_d: float, mask=None):
    """Eval attention without a cache: q, k, v [B, N, C] (f32, or bf16, which
    is widened), src/tgt [B, N, 3] -> [B, N, C] f32. The forward kernel of the
    trainable attention with the LSE store switched off."""
    expect(src, "src", shape=(*q.shape[:2], 3), device=q.device)
    expect(tgt, "tgt", shape=src.shape, device=q.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=q.shape[:2], device=q.device)
    q, k, v = (t.float().contiguous() for t in (q, k, v))
    geom = pack_geometry(src, tgt, mask)
    if not _check_qkv_geom(q, k, v, geom):
        return sc_attention_forward_plain(q, k, v, geom, sigma_d)[0]
    fused_sc_attention.launches += 1
    return _launch_forward(q, k, v, geom, sigma_d, with_lse=False)[0]


sc_attention_forward.launches = 0
sc_attention_backward_dq.launches = 0
sc_attention_backward_dkv.launches = 0
fused_sc_attention.launches = 0
