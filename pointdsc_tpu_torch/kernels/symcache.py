"""The symmetric int8 compat cache at any N (PyTorch wrapper of
``csrc/compat_cache_sym.cu``; counterpart of JAX's triangle + mirror build,
``pointdsc_tpu/kernels/sc_attention.py:318``, and of the kernels of
``tools/exp_symcache.py``, which the port's ``tools/exp_symcache.py``
times).

One launch computes each unordered pair once and writes the mirror from the
computation. The bytes equal the full-grid build's;
``sc_attention.build_compat_cache_int8`` takes this kernel where
``sc_attention.use_symmetric_cache`` says so, and this wrapper at every N
(the experiment, the tests). On a CPU tensor the wrapper runs its plain
version.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels._check import expect, on_cuda
from pointdsc_tpu_torch.kernels.sc_attention import (
    _launch_compat_cache_sym,
    cache_coef,
    compat_cache_plain,
    pack_geometry,
)


def compat_cache_sym_plain(geom: torch.Tensor, coef: float) -> torch.Tensor:
    """Plain version: ``compat_cache_plain``'s upper triangle (diagonal
    included), mirrored into the lower half."""
    full = compat_cache_plain(geom, coef)
    n = full.shape[-1]
    i = torch.arange(n, device=geom.device)
    return torch.where(i[:, None] <= i[None, :], full, full.transpose(-1, -2))


def build_compat_cache_int8_sym(src: torch.Tensor, tgt: torch.Tensor, sigma_d: float,
                                mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, N, N] int8 cache of round(127 * compat) from src/tgt [B, N, 3],
    each unordered pair computed once. As ``build_compat_cache_int8``, the
    mask is checked and otherwise unused."""
    expect(src, "src", ndim=3, last=3)
    expect(tgt, "tgt", shape=src.shape, device=src.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=src.device)
    coef = cache_coef(sigma_d)
    if not on_cuda(src):
        return compat_cache_sym_plain(pack_geometry(src, tgt, mask), coef)
    build_compat_cache_int8_sym.launches += 1
    return _launch_compat_cache_sym(src.float(), tgt.float(), coef)


build_compat_cache_int8_sym.launches = 0
