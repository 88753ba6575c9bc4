"""int8 spatial-consistency cache and the two attention kernels over it,
offset softmax and running max (PyTorch wrappers of ``csrc/compat_cache.cu``
and ``csrc/sc_attention.cu``; counterparts of
``pointdsc_tpu/kernels/sc_attention.py:40-60,236-414,417-640``).

The 12 encoder layers share one compat matrix: it is built once as int8
(value = round(127 * compat)) and each layer streams it through the
attention kernel. On a CPU tensor each wrapper runs its plain PyTorch
version; on a CUDA tensor it launches its kernel or raises.
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
