"""Symmetric int8 compat cache, an experiment (PyTorch wrapper of
``csrc/compat_cache_sym.cu``; counterpart of the kernels of
``tools/exp_symcache.py``, driven by the port's ``tools/exp_symcache.py``).

The cache is built on the upper-triangular square tiles only, then the
strictly-upper tiles are mirrored into the lower half. The bytes equal
``sc_attention.build_compat_cache_int8``'s; the production path keeps that
full-grid kernel. On a CPU tensor the wrapper runs its plain version.
"""

from __future__ import annotations

import functools

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda
from pointdsc_tpu_torch.kernels.sc_attention import cache_coef, compat_cache_plain, pack_geometry

SUB_TILE = 256  # the block side must be a multiple of the kernel's 64 x 256 sub-tile


@functools.lru_cache(maxsize=16)
def tile_lists(nb: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 [T, 2] (tile row, tile column) of the upper-triangular tiles
    (diagonal included) and of the strictly-upper ones, row-major; built and
    copied to the device once per (nb, device), not in every call."""
    up = [(i, j) for i in range(nb) for j in range(i, nb)]
    strict = [(i, j) for i, j in up if j > i]
    return tuple(torch.tensor(p, dtype=torch.int32).reshape(-1, 2).to(device)
                 for p in (up, strict))


def compat_cache_sym_plain(geom: torch.Tensor, coef: float) -> torch.Tensor:
    """Plain version: ``compat_cache_plain``'s upper triangle (diagonal
    included), mirrored into the lower half."""
    full = compat_cache_plain(geom, coef)
    n = full.shape[-1]
    i = torch.arange(n, device=geom.device)
    return torch.where(i[:, None] <= i[None, :], full, full.transpose(-1, -2))


def _launch_sym(geom: torch.Tensor, coef: float, block: int, mirror: bool) -> torch.Tensor:
    b, _, n = geom.shape
    up, strict = tile_lists(n // block, geom.device)
    out = torch.empty((b, n, n), dtype=torch.int8, device=geom.device)
    _build.launch("compat_cache_sym", "compat_cache_tri", geom.device, geom.data_ptr(),
                  up.data_ptr(), out.data_ptr(), b, n, block, up.shape[0], coef)
    if mirror:
        _build.launch("compat_cache_sym", "compat_cache_mirror", geom.device, strict.data_ptr(),
                      out.data_ptr(), b, n, block, strict.shape[0])
    return out


def build_compat_cache_int8_sym(src: torch.Tensor, tgt: torch.Tensor, sigma_d: float,
                                mask: torch.Tensor | None = None, block: int = 256,
                                mirror: bool = True) -> torch.Tensor:
    """[B, N, N] int8 cache of round(127 * compat) from src/tgt [B, N, 3]:
    the upper tiles of side ``block`` (a multiple of 256 that divides N),
    then their mirror. ``mirror=False`` (CUDA only) stops after the upper
    tiles and leaves the lower ones unwritten, to time the two steps apart."""
    expect(src, "src", ndim=3, last=3)
    expect(tgt, "tgt", shape=src.shape, device=src.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=src.device)
    n = src.shape[1]
    if block % SUB_TILE or n % block:
        raise ValueError(f"block {block} must be a multiple of {SUB_TILE} that divides N = {n}")
    geom = pack_geometry(src, tgt, mask)
    coef = cache_coef(sigma_d)
    if not on_cuda(geom):
        if not mirror:
            raise ValueError("mirror=False needs CUDA tensors: it times the kernel's first step")
        return compat_cache_sym_plain(geom, coef)
    build_compat_cache_int8_sym.launches += 1
    return _launch_sym(geom, coef, block, mirror)


build_compat_cache_int8_sym.launches = 0
