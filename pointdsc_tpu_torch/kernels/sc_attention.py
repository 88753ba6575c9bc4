"""int8 spatial-consistency cache and running-max attention over it
(PyTorch wrappers of ``csrc/compat_cache.cu`` and ``csrc/sc_attention.cu``;
counterparts of ``pointdsc_tpu/kernels/sc_attention.py:40-60,236-414,
417-469,590-640``).

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


def fused_sc_attention_cached(q, k, v, compat, src, tgt, mask=None):
    """Running-max attention over the int8 cache: q, k, v [B, N, C] f32,
    compat [B, N, N] int8, src/tgt/mask only for the key-bias row.
    Returns [B, N, C] f32. The kernel takes C = 128."""
    expect(q, "q", dtype=torch.float32, ndim=3)
    for name, t in (("k", k), ("v", v)):
        expect(t, name, dtype=torch.float32, shape=q.shape, device=q.device)
    b, n, c = q.shape
    expect(compat, "compat", dtype=torch.int8, shape=(b, n, n), device=q.device)
    expect(src, "src", shape=(b, n, 3), device=q.device)
    expect(tgt, "tgt", shape=(b, n, 3), device=q.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=(b, n), device=q.device)
    bias = key_bias(mask, b, n, q.device)
    if not on_cuda(q):
        return sc_attention_cached_plain(q, k, v, compat, bias)
    if c != C_KERNEL:
        raise ValueError(f"the attention kernel takes C={C_KERNEL}, got C={c}")
    fused_sc_attention_cached.launches += 1
    return _launch_sc_attention(q, k, v, compat, bias)


fused_sc_attention_cached.launches = 0
