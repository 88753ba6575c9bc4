"""Batched weighted Procrustes (PyTorch counterpart of
``pointdsc_tpu/ops/procrustes.py:45-117``).

Horn's quaternion method: the optimal rotation's quaternion is the leading
eigenvector of a symmetric 4x4 built from H = sum w a b^T, solved in closed
form or by cyclic Jacobi (ops/linalg.py). It always returns a proper rotation, the same one the
reference's SVD with the det-sign fix picks.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.ops.linalg import dominant_eigvec4x4, symeig4x4
from pointdsc_tpu_torch.ops.se3 import integrate_trans


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1),
        ],
        dim=-2,
    )


def horn_matrix(H: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric 4x4 [..., 4, 4] of H [..., 3, 3]: its leading
    eigenvector is the quaternion of the rotation maximizing tr(R H)."""
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    return torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
        ],
        dim=-2,
    )


def rotation_from_covariance(H: torch.Tensor, sweeps: int = 10,
                             method: str = "newton") -> torch.Tensor:
    """Optimal proper rotation R maximizing tr(R H) (R @ a ~= b). method
    "newton" solves the characteristic quartic in closed form; "jacobi" runs
    ``sweeps`` cyclic Jacobi sweeps on the 4x4 and takes its leading
    eigenvector (gap-independent accuracy)."""
    N = horn_matrix(H)
    if method == "newton":
        _, q = dominant_eigvec4x4(N)
    elif method == "jacobi":
        q = symeig4x4(N, sweeps=sweeps)[1][..., :, -1]  # eigenvalues ascend
    else:
        raise ValueError(f"unknown method {method!r}")
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    return _quat_to_rot(q)


def weighted_procrustes(src: torch.Tensor, tgt: torch.Tensor,
                        weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted rigid fit src -> tgt ([..., K, 3] each, weights [..., K]).
    Returns [..., 4, 4]. Semantics of the reference ``rigid_transform_3d`` at
    its default threshold 0: negative weights are zeroed, centroids divide
    by sum(w) + 1e-6."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    weights = torch.where(weights < 0.0, torch.zeros_like(weights), weights)

    wsum = torch.sum(weights, dim=-1, keepdim=True) + 1e-6
    centroid_src = torch.sum(src * weights[..., None], dim=-2) / wsum
    centroid_tgt = torch.sum(tgt * weights[..., None], dim=-2) / wsum
    src_c = src - centroid_src[..., None, :]
    tgt_c = tgt - centroid_tgt[..., None, :]
    H = torch.einsum("...ki,...k,...kj->...ij", src_c, weights, tgt_c)

    R = rotation_from_covariance(H)
    t = centroid_tgt - torch.einsum("...ij,...j->...i", R, centroid_src)
    return integrate_trans(R, t)
