"""Frame-to-frame RGB-D and depth odometry (PyTorch counterpart of
``pointdsc_tpu/fusion/odometry.py``).

Replaces the Open3D RGB-D odometry of the reference's fragment pipeline
(multiway/make_fragments.py:64-109):

  * ``depth_odometry``: projective point-to-plane ICP (KinectFusion-style):
    each source point is projected into the target depth image (O(N)
    association), then one 6x6 normal-equation solve per iteration;
  * ``rgbd_odometry``: the hybrid photometric + geometric objective of
    Open3D's ``RGBDOdometryJacobianFromHybridTerm`` (Park et al. 2017):
    sigma * r_plane^2 + (1 - sigma) * r_I^2 over the same twist, with the
    target intensity and its gradients sampled bilinearly.

Each runs a fixed number of steps (the JAX package's ``lax.scan``) that
never reads a value back to the host: a step with too few matches keeps its
transform through ``torch.where``, and the solve does not check for errors.
Projections, normals and warps are written out elementwise
(fusion/camera.py), so that a pixel's association rounds alike on the CPU
and the card.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.fusion.camera import (
    PinholeIntrinsics,
    backproject_depth,
    cross,
    div,
    project_points,
    rigid_apply,
)
from pointdsc_tpu_torch.ops.lie import se3_exp


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])


def depth_normals(depth: torch.Tensor, intr: PinholeIntrinsics) -> torch.Tensor:
    """Per-pixel normals from cross products of backprojected image
    differences (wrapping around the border, as ``jnp.roll``). Returns
    [H, W, 3], 0 where a pixel or its right or lower neighbour is invalid."""
    pts, valid = backproject_depth(depth, intr)
    h, w = depth.shape
    P = pts.reshape(h, w, 3)
    V = valid.reshape(h, w)
    dx = torch.roll(P, -1, dims=1) - P
    dy = torch.roll(P, -1, dims=0) - P
    n = cross(dy, dx)
    n = n / torch.clamp(_norm3(n), min=1e-9)[..., None]
    ok = V & torch.roll(V, -1, dims=1) & torch.roll(V, -1, dims=0)
    return torch.where(ok[..., None], n, torch.zeros_like(n))


def _source_points(depth_src, intr, stride):
    src_pts, src_valid = backproject_depth(depth_src, intr)
    h, w = depth_src.shape
    flat = torch.arange(h * w, device=depth_src.device)
    sel = (flat % stride == 0) & ((flat // w) % stride == 0)
    return src_pts, src_valid & sel


def _associate(src_pts, trans, intr, h, w):
    """Warp the source points by trans, project them; the rounded pixel
    (clipped) and the inside mask of the unrounded one."""
    warped = rigid_apply(src_pts, trans)
    uv, in_front = project_points(warped, intr)
    ui = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, w - 1)
    vi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, h - 1)
    return warped, uv, in_front, ui, vi


def _solve_step(H, b, trans, enough):
    """trans updated by exp(-H^-1 b) where ``enough``, else kept."""
    xi = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
    new_trans = se3_exp(xi) @ trans
    return torch.where(enough, new_trans, trans)


def _inputs(dev, init_trans, *images):
    init = torch.eye(4) if init_trans is None else torch.as_tensor(init_trans)
    return [init.to(device=dev, dtype=torch.float32)] + [
        torch.as_tensor(im).to(device=dev, dtype=torch.float32) for im in images]


@full_f32_matmul()
def depth_odometry(depth_src, depth_tgt, intr: PinholeIntrinsics, init_trans=None,
                   iters: int = 20, max_depth_diff: float = 0.07, stride: int = 2,
                   device: str | torch.device = "cuda"):
    """Estimate T with T(src points) ~= tgt points (camera_src -> camera_tgt).
    Returns (trans [4, 4], inlier_fraction []), tensors on ``device``."""
    dev = resolve_device(device)
    trans, depth_src, depth_tgt = _inputs(dev, init_trans, depth_src, depth_tgt)
    h, w = depth_src.shape
    src_pts, src_valid = _source_points(depth_src, intr, stride)
    tgt_pts_img, tgt_valid_flat = backproject_depth(depth_tgt, intr)
    tgt_P = tgt_pts_img.reshape(h, w, 3)
    tgt_V = tgt_valid_flat.reshape(h, w)
    tgt_N = depth_normals(depth_tgt, intr)
    eye6 = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)

    count = None
    for _ in range(iters):
        warped, uv, in_front, ui, vi = _associate(src_pts, trans, intr, h, w)
        inside = (uv[:, 0] >= 0) & (uv[:, 0] <= w - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= h - 1)
        q = tgt_P[vi, ui]  # associated target points
        n = tgt_N[vi, ui]
        ok = (src_valid & in_front & inside & tgt_V[vi, ui]
              & (torch.abs(warped[:, 2] - q[:, 2]) < max_depth_diff)
              & (torch.sum(n * n, dim=-1) > 0.5))
        wgt = ok.to(warped.dtype)
        # point-to-plane residual r = n . (p' - q); dr/dw = p' x n, dr/dv = n
        r = torch.sum(n * (warped - q), dim=-1)
        J = torch.cat([cross(warped, n), n], dim=-1)  # [N, 6]
        H = torch.einsum("ni,nj,n->ij", J, J, wgt) + eye6
        b = torch.einsum("ni,n,n->i", J, r, wgt)
        count = torch.sum(wgt)
        trans = _solve_step(H, b, trans, count > 100)
    frac = count / torch.clamp(torch.sum(src_valid), min=1)
    return trans, frac


def _bilinear(img: torch.Tensor, uv: torch.Tensor):
    """Bilinear sample img [H, W] at uv [N, 2]; returns (values, inside)."""
    h, w = img.shape
    u, v = uv[:, 0], uv[:, 1]
    inside = (u >= 0) & (u <= w - 1.0) & (v >= 0) & (v <= h - 1.0)
    u = torch.clamp(u, 0.0, w - 1.0)
    v = torch.clamp(v, 0.0, h - 1.0)
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, w - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, h - 2)
    du, dv = u - u0, v - v0
    i00 = img[v0, u0]
    i01 = img[v0, u0 + 1]
    i10 = img[v0 + 1, u0]
    i11 = img[v0 + 1, u0 + 1]
    val = (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
           + i10 * (1 - du) * dv + i11 * du * dv)
    return val, inside


def image_gradients(img: torch.Tensor):
    """Central-difference gradients (gx, gy) of an [H, W] image, in
    intensity per pixel (wrapping as ``jnp.roll``, then the borders zeroed)."""
    gx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    gy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))
    gx[:, 0] = 0.0
    gx[:, -1] = 0.0
    gy[0, :] = 0.0
    gy[-1, :] = 0.0
    return gx, gy


@full_f32_matmul()
def rgbd_odometry(intensity_src, depth_src, intensity_tgt, depth_tgt, intr: PinholeIntrinsics,
                  init_trans=None, iters: int = 20, max_depth_diff: float = 0.07,
                  stride: int = 2, sigma: float = 0.968, device: str | torch.device = "cuda"):
    """Hybrid photometric + geometric odometry (camera_src -> camera_tgt).

    Args:
        intensity_*: [H, W] grayscale in [0, 1].
        sigma: geometric-term weight; (1 - sigma) weighs the squared
            intensity residual (Open3D/Park default 0.968).

    Returns (trans [4, 4], inlier_fraction []), tensors on ``device``."""
    dev = resolve_device(device)
    trans, i_src, depth_src, i_tgt, depth_tgt = _inputs(
        dev, init_trans, intensity_src, depth_src, intensity_tgt, depth_tgt)
    h, w = depth_src.shape
    src_pts, src_valid = _source_points(depth_src, intr, stride)
    src_I = i_src.reshape(-1)  # intensity at each source pixel
    tgt_pts_img, tgt_valid_flat = backproject_depth(depth_tgt, intr)
    tgt_P = tgt_pts_img.reshape(h, w, 3)
    tgt_V = tgt_valid_flat.reshape(h, w)
    tgt_N = depth_normals(depth_tgt, intr)
    gx, gy = image_gradients(i_tgt)
    w_geo = torch.tensor(sigma, dtype=torch.float32, device=dev)
    w_pho = torch.tensor(1.0 - sigma, dtype=torch.float32, device=dev)
    eye6 = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)
    fx = torch.tensor(intr.fx, dtype=torch.float32, device=dev)
    fy = torch.tensor(intr.fy, dtype=torch.float32, device=dev)

    count = None
    for _ in range(iters):
        warped, uv, in_front, ui, vi = _associate(src_pts, trans, intr, h, w)
        q = tgt_P[vi, ui]
        n = tgt_N[vi, ui]
        I_t, inside = _bilinear(i_tgt, uv)
        gxv, _ = _bilinear(gx, uv)
        gyv, _ = _bilinear(gy, uv)
        ok = (src_valid & in_front & inside & tgt_V[vi, ui]
              & (torch.abs(warped[:, 2] - q[:, 2]) < max_depth_diff))
        ok_geo = ok & (torch.sum(n * n, dim=-1) > 0.5)
        wg = ok_geo.to(torch.float32) * w_geo
        wp = ok.to(torch.float32) * w_pho

        # geometric point-to-plane rows
        r_g = torch.sum(n * (warped - q), dim=-1)
        J_g = torch.cat([cross(warped, n), n], dim=-1)  # [N, 6]

        # photometric rows: r = I_tgt(pi(p')) - I_src;
        # dI/dxi = [gx gy] . dpi/dp' . [ -[p']x | I ]
        x, y = warped[:, 0], warped[:, 1]
        z = torch.clamp(warped[:, 2], min=1e-6)
        zeros = torch.zeros_like(z)
        du_dp = torch.stack([fx / z, zeros, -fx * x / (z * z)], dim=-1)
        dv_dp = torch.stack([zeros, fy / z, -fy * y / (z * z)], dim=-1)
        gI = gxv[:, None] * du_dp + gyv[:, None] * dv_dp  # [N, 3] = dI/dp'
        # dr/dw_k = (p' x gI)_k, the triple-product identity of the geometric row
        r_p = I_t - src_I
        # robust-ish weighting: Huber-like on the photometric residuals
        wp_r = wp / (1.0 + div(torch.abs(r_p), 0.03))
        J_p = torch.cat([cross(warped, gI), gI], dim=-1)  # [N, 6]

        H = (torch.einsum("ni,nj,n->ij", J_g, J_g, wg)
             + torch.einsum("ni,nj,n->ij", J_p, J_p, wp_r) + eye6)
        b = (torch.einsum("ni,n,n->i", J_g, r_g, wg)
             + torch.einsum("ni,n,n->i", J_p, r_p, wp_r))
        count = torch.sum(ok)
        trans = _solve_step(H, b, trans, count > 100)
    frac = count / torch.clamp(torch.sum(src_valid), min=1)
    return trans, frac
