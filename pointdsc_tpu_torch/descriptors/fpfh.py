"""FPFH descriptors (PyTorch counterpart of ``pointdsc_tpu/descriptors/fpfh.py``).

Voxel downsample (numpy) -> normals -> 33-bin FPFH histograms, the
reference's Open3D pipeline (misc/cal_fpfh.py) without Open3D:
  * neighbourhoods are the k nearest points within the radius (fixed k,
    radius-masked), from a chunked gram-form distance rounded alike on the
    CPU and the card, and a stable sort, which breaks ties to the lower index
    as ``jax.lax.top_k`` does;
  * normals are the smallest eigenvector of the neighbourhood covariance
    (cyclic Jacobi, ops/linalg.py), oriented towards the origin;
  * the histograms are one-hot sums; FPFH adds the 1/distance-weighted mean
    of the neighbours' SPFH.
Histogram bins are discontinuous: a last-bit difference in an angle can move
one neighbour to the next bin. Matrix products run in full float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.ops.linalg import fma_chain, symeig3x3
from pointdsc_tpu_torch.ops.nms import top_k_like_jax

_BIG = 1e9


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Mean of the points of every occupied voxel, voxels in lexicographic
    order (numpy, float64 sums, float32 result)."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inv.reshape(-1), points)
    return (sums / counts[:, None]).astype(np.float32)


def _chunked_radius_knn(points: torch.Tensor, k: int, radius: float, chunk: int = 2048):
    """For each point, the indices of its k nearest other points and whether
    each lies within ``radius``: (idx [N, k] int64, valid [N, k] bool). One
    [chunk, N] block of distances at a time.

    d2 = |q|² + |p|² − 2 q·p as the JAX package forms it, with every operation
    written out so that the CPU and the card round it alike: |p|² as
    ((x² + y²) + z²) and q·p as the CPU's matrix product of depth 3 rounds it
    (``fma_chain``: the x-product, then a fused multiply-add for y and for
    z). The form
    cancels ~ulp(|p|²) (~5e-7 m² at 2.5 m from the origin), so a product that
    rounds otherwise (cuBLAS) moves neighbours of voxel-mean keypoints across
    the radius, and through the normals changes whole histograms."""
    n = points.shape[0]
    if n < k:
        raise ValueError(f"{n} points, fewer than the {k} neighbours asked for")
    x, y, z = points.unbind(-1)
    sq_all = (x * x + y * y) + z * z
    cols = torch.arange(n, device=points.device)
    idxs, valids = [], []
    for start in range(0, n, chunk):
        q = points[start:start + chunk]
        dot = fma_chain((q[:, a, None], points[None, :, a]) for a in range(3))
        d2 = sq_all[start:start + chunk, None] + sq_all[None, :] - 2.0 * dot
        d2 = torch.clamp(d2, min=0.0)
        rows = cols[start:start + chunk]
        d2 = torch.where(rows[:, None] == cols[None, :], torch.full_like(d2, _BIG), d2)
        idx = top_k_like_jax(-d2, k)
        idxs.append(idx)
        valids.append(torch.gather(d2, 1, idx) < radius * radius)
    return torch.cat(idxs), torch.cat(valids)


@full_f32_matmul()
def estimate_normals(points: torch.Tensor, radius: float, max_nn: int = 30) -> torch.Tensor:
    """Normals [N, 3] of points [N, 3]: the smallest eigenvector of the
    radius-masked k-NN covariance, oriented towards the origin (the camera
    of a depth-sensor fragment). The Jacobi solve rounds as ops/linalg.py
    says; a point with two neighbours has a rank-1 covariance, whose null
    plane holds any normal, and rounding picks the one that comes out."""
    cov = neighbourhood_covariance(points, radius, max_nn)
    normal = symeig3x3(cov)[1][..., :, 0]  # smallest eigenvalue: the surface normal
    flip = (normal[:, 0] * points[:, 0] + normal[:, 1] * points[:, 1]) \
        + normal[:, 2] * points[:, 2] > 0
    return torch.where(flip[:, None], -normal, normal)


def neighbourhood_covariance(points: torch.Tensor, radius: float,
                             max_nn: int = 30) -> torch.Tensor:
    """[N, 3, 3]: the covariance of each point's radius-masked k nearest
    neighbours about their mean, each sum rounded as the JAX package's CPU
    run rounds it: the masked mean as a sum over the neighbours in order,
    the covariance as an ``fma_chain`` over them."""
    idx, valid = _chunked_radius_knn(points, max_nn, radius)
    neigh = points[idx]  # [N, k, 3]
    w = valid.to(points.dtype)[..., None]
    count = torch.clamp(torch.sum(w, dim=1), min=1.0)
    weighted = neigh * w
    total = weighted[:, 0]
    for j in range(1, weighted.shape[1]):
        total = total + weighted[:, j]
    mean = total / count
    centered = (neigh - mean[:, None]) * w
    return torch.stack([
        torch.stack([fma_chain((centered[:, j, a], centered[:, j, b])
                               for j in range(centered.shape[1])) for b in range(3)], dim=-1)
        for a in range(3)], dim=-2) / count[..., None]


def _angle_histograms(alpha, phi, theta, wmask, bins: int = 11):
    """Per-point 3 x ``bins`` histograms of the Darboux angles over the valid
    neighbours, as percentages (Open3D's convention)."""

    def hist(x, lo, hi):
        span = torch.tensor(hi - lo, dtype=x.dtype, device=x.device)  # a true division
        t = torch.clamp((x - lo) / span, 0.0, 1.0 - 1e-7)
        b = torch.floor(t * bins).long()
        onehot = torch.nn.functional.one_hot(b, bins).to(x.dtype) * wmask[..., None]
        return torch.sum(onehot, dim=1)  # [N, bins]

    h = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                   hist(theta, -math.pi, math.pi)], dim=-1)  # [N, 33]
    count = torch.clamp(torch.sum(wmask, dim=1, keepdim=True), min=1.0)
    return h * (torch.full_like(count, 100.0) / count)


@full_f32_matmul()
def fpfh_features(points: torch.Tensor, normals: torch.Tensor, radius: float,
                  max_nn: int = 100) -> torch.Tensor:
    """33-dim FPFH (Rusu et al. 2009) [N, 33]: SPFH histograms of the
    Darboux-frame angles, then FPFH(p) = SPFH(p) + (1/k) sum_q SPFH(q) /
    dist(p, q) over the same neighbourhoods."""
    idx, valid = _chunked_radius_knn(points, max_nn, radius)
    p = points[:, None]  # [N, 1, 3]
    q = points[idx]  # [N, k, 3]
    nq = normals[idx]
    d = q - p
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    du = d / dist[..., None]

    # Darboux frame at p: u = n_p, v = u x du, w = u x v
    u = normals[:, None].expand(d.shape)
    v = torch.linalg.cross(du, u, dim=-1)
    v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)
    w = torch.linalg.cross(u, v, dim=-1)

    alpha = torch.sum(v * nq, dim=-1)
    phi = torch.sum(du * u, dim=-1)
    theta = torch.atan2(torch.sum(w * nq, dim=-1), torch.sum(u * nq, dim=-1))

    wmask = valid.to(points.dtype)
    spfh = _angle_histograms(alpha, phi, theta, wmask)

    inv_d = torch.where(valid, 1.0 / torch.clamp(dist, min=1e-6), torch.zeros_like(dist))
    k_eff = torch.clamp(torch.sum(wmask, dim=1, keepdim=True), min=1.0)
    agg = torch.sum(spfh[idx] * inv_d[..., None], dim=1) / k_eff
    return spfh + agg


def extract_fpfh(points: np.ndarray, voxel_size: float = 0.03, normal_radius: float | None = None,
                 feature_radius: float | None = None, device: str | torch.device = "cuda"):
    """The whole pipeline on a raw cloud [P, 3]: (keypts [M, 3] float32,
    features [M, 33] float32), numpy. Radii default to the reference's 2x
    and 5x the voxel size (misc/cal_fpfh.py, demo_registration.py:37-44)."""
    dev = resolve_device(device)
    normal_radius = normal_radius or voxel_size * 2.0
    feature_radius = feature_radius or voxel_size * 5.0
    down = voxel_downsample(np.asarray(points, np.float64), voxel_size)
    pts = torch.as_tensor(down, device=dev)
    normals = estimate_normals(pts, normal_radius, max_nn=30)
    feats = fpfh_features(pts, normals, feature_radius, max_nn=100)
    return down, feats.cpu().numpy()
