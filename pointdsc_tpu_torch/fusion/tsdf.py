"""Dense TSDF volume fusion and surface point extraction (PyTorch counterpart
of ``pointdsc_tpu/fusion/tsdf.py``).

Replaces Open3D's ScalableTSDFVolume of the reference's fragment pipeline
(multiway/make_fragments.py:112-140) by a dense voxel grid (default 256^3 at
8 mm, 2 m across). Each depth frame's integration is one vectorized pass
over every voxel: project its center, gather the depth, update (tsdf,
weight) by the truncated projective SDF running average. At 256^3 the pass
holds ~2 GB of temporaries on the card.

The camera's inverse is taken on the CPU in float32 (a 4x4) and the voxel
centers are warped and projected elementwise (fusion/camera.py), so that
the card and the CPU associate every voxel with the same pixel.

Surface points come from zero crossings of the TSDF along the three axes
(linear interpolation), numpy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.fusion.camera import PinholeIntrinsics, div, project_points, rigid_apply


def _integrate(tsdf, weight, origin, voxel_size: float, sdf_trunc: float, depth, world_to_cam,
               intr: PinholeIntrinsics, dims):
    d, h_, w_ = dims
    # each temporary is freed once used: at 256^3 one is 67-201 MB
    idx = torch.arange(d * h_ * w_, device=tsdf.device)
    iz = idx % w_
    iy = (idx // w_) % h_
    ix = idx // (w_ * h_)
    grid = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
    del idx, ix, iy, iz
    centers = (grid + 0.5) * voxel_size + origin  # [M, 3] world
    del grid
    cam_pts = rigid_apply(centers, world_to_cam)
    del centers
    uv, in_front = project_points(cam_pts, intr)
    H, W = depth.shape
    ui = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
    inside = (uv[:, 0] >= 0) & (uv[:, 0] <= W - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1)
    del uv
    depth_val = depth[vi, ui]
    del ui, vi
    sdf = depth_val - cam_pts[:, 2]
    del cam_pts
    valid = in_front & inside & (depth_val > 1e-4) & (sdf > -sdf_trunc)
    tsdf_new = torch.clamp(div(sdf, sdf_trunc), -1.0, 1.0)

    w_old = weight.reshape(-1)
    t_old = tsdf.reshape(-1)
    w_new = w_old + valid.to(torch.float32)
    t_new = torch.where(valid, (t_old * w_old + tsdf_new) / torch.clamp(w_new, min=1.0), t_old)
    return t_new.reshape(dims), w_new.reshape(dims)


@dataclass
class TSDFVolume:
    """Dense TSDF grid on ``device``. ``dims`` are (X, Y, Z) voxel counts."""

    origin: np.ndarray
    voxel_size: float = 0.008
    sdf_trunc: float = 0.04
    dims: tuple = (256, 256, 256)
    tsdf: torch.Tensor = field(default=None)
    weight: torch.Tensor = field(default=None)
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.tsdf is None:
            self.tsdf = torch.ones(self.dims, dtype=torch.float32, device=self.device)
        if self.weight is None:
            self.weight = torch.zeros(self.dims, dtype=torch.float32, device=self.device)

    def integrate(self, depth, intr: PinholeIntrinsics, cam_to_world):
        """Fuse one depth frame [H, W] (meters) seen from cam_to_world [4, 4]."""
        world_to_cam = torch.linalg.inv(torch.as_tensor(cam_to_world).to("cpu", torch.float32))
        self.tsdf, self.weight = _integrate(
            self.tsdf, self.weight,
            torch.as_tensor(np.asarray(self.origin, np.float32), device=self.device),
            float(np.float32(self.voxel_size)), float(np.float32(self.sdf_trunc)),
            torch.as_tensor(depth).to(self.device, torch.float32),
            world_to_cam.to(self.device), intr, tuple(self.dims))


def extract_surface_points(vol: TSDFVolume, min_weight: float = 1.0) -> np.ndarray:
    """Zero-crossing surface points with linear interpolation along x/y/z."""
    t = vol.tsdf.cpu().numpy()
    w = vol.weight.cpu().numpy()
    pts = []
    for axis in range(3):
        t0 = t
        t1 = np.roll(t, -1, axis=axis)
        w0, w1 = w, np.roll(w, -1, axis=axis)
        cross = (t0 * t1 < 0) & (w0 >= min_weight) & (w1 >= min_weight)
        # drop the wrap-around border slice
        sl = [slice(None)] * 3
        sl[axis] = slice(-1, None)
        cross[tuple(sl)] = False
        ix, iy, iz = np.nonzero(cross)
        frac = t0[ix, iy, iz] / (t0[ix, iy, iz] - t1[ix, iy, iz])
        base = np.stack([ix, iy, iz], axis=-1).astype(np.float64) + 0.5
        step = np.zeros_like(base)
        step[:, axis] = frac
        pts.append((base + step) * vol.voxel_size + vol.origin)
    return np.concatenate(pts, axis=0)
