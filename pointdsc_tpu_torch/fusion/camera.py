"""Pinhole camera model: backprojection and projection for depth images
(PyTorch counterpart of ``pointdsc_tpu/fusion/camera.py``).

Every product is written out elementwise in a fixed order, and every
division is a true division (``div``), so that the CPU and the card round
each coordinate alike: the pixel a point projects to is a ``round`` of it,
and a last-bit difference would move it to the next pixel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PinholeIntrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def primesense_default(cls) -> "PinholeIntrinsics":
        """The PrimeSense/Redwood default of the reference's fragment pipeline
        (multiway/initialize_config.py)."""
        return cls(640, 480, 525.0, 525.0, 319.5, 239.5)


def div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s rounded once, on the CPU and on the card: CUDA divides a tensor
    by a Python number as a product with its reciprocal, two roundings."""
    return a / a.new_tensor(s)


def backproject_depth(depth: torch.Tensor, intr: PinholeIntrinsics, depth_trunc: float = 4.0):
    """Depth image [H, W] (meters) -> points [H*W, 3] + validity [H*W].
    Invalid pixels (0 or beyond depth_trunc) are masked, not dropped."""
    h, w = depth.shape
    us = torch.arange(w, dtype=depth.dtype, device=depth.device)
    vs = torch.arange(h, dtype=depth.dtype, device=depth.device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    z = depth
    valid = (z > 1e-4) & (z < depth_trunc)
    x = div(uu - intr.cx, intr.fx) * z
    y = div(vv - intr.cy, intr.fy) * z
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3), valid.reshape(-1)


def project_points(pts: torch.Tensor, intr: PinholeIntrinsics):
    """Points [N, 3] (camera frame) -> pixel coords [N, 2] + in-front mask."""
    z = pts[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    u = pts[..., 0] / safe_z * intr.fx + intr.cx
    v = pts[..., 1] / safe_z * intr.fy + intr.cy
    return torch.stack([u, v], dim=-1), z > 1e-4


def rigid_apply(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """R p + t for pts [N, 3] and trans [4, 4], each coordinate as
    ((R_0 x + R_1 y) + R_2 z) + t in separate roundings (no matrix product,
    whose reduction order differs between the CPU and cuBLAS)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rows = [((trans[r, 0] * x + trans[r, 1] * y) + trans[r, 2] * z) + trans[r, 3]
            for r in range(3)]
    return torch.stack(rows, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, each component a product difference in two
    roundings (a fused multiply-add would round it once on the card)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)
