"""SO(3)/SE(3) exponential and logarithm maps (batched, Taylor-safe; PyTorch
counterpart of ``pointdsc_tpu/ops/lie.py``).

The pose-graph optimizer (multiway/pose_graph.py) differentiates these maps
with ``torch.func.jacrev`` at zero increments, so every branch is written
branch-free with ``torch.where`` and the untaken branch is evaluated at a
benign argument: ``torch.where`` sends a zero gradient into the branch it
did not take, and that zero times the branch's local derivative must stay
0, not 0 * inf = NaN.

Conventions: twists are [rx, ry, rz, tx, ty, tz] (rotation first); matrices
act on column vectors.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(K) + torch.eye(3, dtype=K.dtype, device=K.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta2 = torch.sum(w * w, dim=-1)
    # the quotients are evaluated at theta = 1 where the series is taken
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = skew(w)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    return _eye_like(K) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (|w| in [0, pi])."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    # strict interior clamp: arccos' is infinite at +-1, which would put NaN
    # into the Jacobians of zero-residual (identity) edges
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0,  # theta / (2 sin) series
                        theta / (2.0 * torch.where(small, torch.ones_like(sin), sin) + _EPS))
    w = vee * scale[..., None]
    # near pi the vee part vanishes: the axis from diag(R); sqrt(x + tiny)
    # keeps this branch's gradient finite where it is not taken
    near_pi = theta > 3.1
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    axis_sq = torch.clamp((diag - cos[..., None]) / torch.clamp(1.0 - cos[..., None], min=1e-8),
                          min=0.0)
    axis = torch.sqrt(axis_sq + 1e-12)
    one = torch.ones_like(theta)
    signs = torch.stack([torch.where(vee[..., k] >= 0, one, -one) for k in range(3)], dim=-1)
    w_pi = axis * signs * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def _V_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): V with exp-translation t = V rho; the safe
    pattern of ``so3_exp`` (the f32 derivative of (theta - sin) / theta^3 at
    theta ~ 1e-8 would overflow)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = skew(w)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return _eye_like(K) + B[..., None, None] * K + C[..., None, None] * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist (w, rho) -> [..., 4, 4] transform."""
    w, rho = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_V_matrix(w) @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :]) + top.new_tensor([0.0, 0.0, 0.0, 1.0])
    return torch.cat([top, bottom], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] transform -> [..., 6] twist (w, rho)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    rho = torch.linalg.solve(_V_matrix(w), t[..., None])[..., 0]
    return torch.cat([w, rho], dim=-1)
