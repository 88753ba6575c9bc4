"""Exact seed k-NN in feature space (PyTorch wrapper of
``csrc/seed_knn.cu``; counterpart of ``pointdsc_tpu/kernels/seed_knn.py``).

For each seed, the k correspondences with the largest inner product of
L2-normalised features (the nearest ones), never the seed itself nor an
invalid point, in descending order with ties to the lower index. On the
card the kernel is two launches behind one entry: the [S, N] similarities
into a scratch the wrapper allocates ([B, S, N rounded up to 64] f32: 10 MB
at N = 5120, 60 MB at 12288, 168 MB at 20480 with S = 2048), then an exact
radix select per seed row. The features are zero-padded to a multiple of
128 channels (the same inner products); the product walks them 32 at a
time. On a CPU tensor
the wrapper runs its plain version; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import check_width, expect, on_cuda, pad_channels

K_MAX = 128  # the kernel's list capacity
TILE_N = 64  # the scratch rows are padded to the similarity kernel's tile
_MASKED, _SELF = -1e30, -3e38  # below every real similarity; self below masked


def knn_bias(mask: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """[B, N] f32: 0 for a valid candidate, -1e30 for an invalid one."""
    if mask is None:
        return torch.zeros(like.shape[:2], dtype=torch.float32, device=like.device)
    return torch.where(mask, 0.0, _MASKED).to(torch.float32)


def seed_knn_plain(features, seeds, k, bias):
    """Plain version: the [B, S, N] similarities, the kernel's masking and a
    stable descending sort (ties to the lower index, as the kernel)."""
    seed_feats = torch.gather(features, 1, seeds[..., None].expand(-1, -1, features.shape[-1]))
    sim = torch.einsum("bsc,bnc->bsn", seed_feats, features)
    sim = torch.where(bias[:, None, :] != 0.0, torch.full_like(sim, _MASKED), sim)
    cols = torch.arange(features.shape[1], device=features.device)
    sim = torch.where(cols[None, None, :] == seeds[..., None], torch.full_like(sim, _SELF), sim)
    return torch.sort(sim, dim=-1, descending=True, stable=True).indices[..., :k].contiguous()


def _launch_knn(features, seeds32, k, bias):
    b, n, c = features.shape
    s = seeds32.shape[1]
    idx = torch.empty((b, s, k), dtype=torch.int64, device=features.device)
    scratch = torch.empty((b, s, -(-n // TILE_N) * TILE_N), dtype=torch.float32,
                          device=features.device)
    _build.launch("seed_knn", "seed_knn_exact", features.device, features.data_ptr(),
                  seeds32.data_ptr(), bias.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                  b, n, s, k, c)
    return idx


def seed_knn_exact(features, seeds, k, mask=None):
    """[B, S, k] int64 neighbour indices of the seeds [B, S] among
    features [B, N, C] (L2-normalised f32), excluding invalid points (mask
    [B, N] bool) and each seed itself."""
    expect(features, "features", dtype=torch.float32, ndim=3)
    b, n, c = features.shape
    expect(seeds, "seeds", dtype=torch.int64, ndim=2, device=features.device)
    if seeds.shape[0] != b:
        raise ValueError(f"seeds have batch {seeds.shape[0]}, features {b}")
    if not 1 <= k < n:
        raise ValueError(f"k must lie in [1, N), got k={k} at N={n}")
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=(b, n), device=features.device)
    bias = knn_bias(mask, features)
    if not on_cuda(features):
        return seed_knn_plain(features, seeds, k, bias)
    check_width(c, "the seed k-NN kernel")
    if k > K_MAX:
        raise ValueError(f"the seed k-NN kernel takes k<={K_MAX}, got k={k}")
    features = pad_channels(features)
    if features.data_ptr() % 16:
        raise ValueError("features must be 16-byte aligned (float4 rows)")
    seed_knn_exact.launches += 1
    return _launch_knn(features, seeds.to(torch.int32).contiguous(), k, bias)


seed_knn_exact.launches = 0
