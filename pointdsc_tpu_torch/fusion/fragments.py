"""Fragments: RGB-D sequence -> TSDF-fused fragment point clouds
(PyTorch counterpart of ``pointdsc_tpu/fusion/fragments.py``).

Rebuilds the reference's multiway/make_fragments.py:64-175 without Open3D:
frames are chunked into fragments (100 frames each, the reference's
n_frames_per_fragment), chained by frame-to-frame odometry, refined by a
per-fragment pose graph with keyframe loop-closure edges, fused into a dense
TSDF volume, and the extracted surface points are written as
``fragment_%03d.ply`` with the ``fragment_%03d.npy`` pose and an FPFH
``fragment_%03d_fpfh.npz``: what ``data/redwood.py::RedwoodDataset`` reads.

Depth images are 16-bit PNGs (millimeters, depth_scale = 1000), decoded by
``data/png.py``; color PNGs too. A ``.jpg`` color frame needs PIL, imported
only there.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.data.png import read_png, to_luma
from pointdsc_tpu_torch.fusion.camera import PinholeIntrinsics, backproject_depth
from pointdsc_tpu_torch.fusion.odometry import depth_odometry, rgbd_odometry
from pointdsc_tpu_torch.fusion.tsdf import TSDFVolume, extract_surface_points
from pointdsc_tpu_torch.multiway.pose_graph import PoseGraph, PoseGraphEdge, optimize_pose_graph


def read_depth_png(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a depth image has one channel, not {img.shape[-1]}")
    return img.astype(np.float32) / depth_scale


def read_intensity_png(path: str) -> np.ndarray:
    """Color frame -> grayscale intensity in [0, 1] (Open3D's RGB-D odometry
    likewise converts to float intensity): PIL's ``convert("L")`` luma."""
    if path.lower().endswith(".png"):
        luma = to_luma(read_png(path))
    else:
        try:
            from PIL import Image
        except ImportError as exc:
            raise RuntimeError(
                f"{path}: reading a JPEG color frame needs PIL (Pillow), which is not "
                "installed; data/png.py decodes PNG frames only") from exc
        luma = np.asarray(Image.open(path).convert("L"))
    return luma.astype(np.float32) / 255.0


def build_fragment(depth_paths: list, intr: PinholeIntrinsics | None = None,
                   voxel_size: float = 0.008, sdf_trunc: float = 0.04, keyframe_every: int = 5,
                   depth_trunc: float = 4.0, grid_dims: tuple = (256, 256, 256),
                   color_paths: list | None = None, device: str | torch.device = "cuda"):
    """Fuse one fragment from depth frames (paths or [H, W] arrays in meters).
    Returns (points [N, 3], frame poses list of 4x4 cam -> fragment). With
    ``color_paths`` the tracking is the hybrid photometric + geometric
    objective (reference make_fragments.py:64-109), else point-to-plane
    depth odometry."""
    dev = resolve_device(device)
    intr = intr or PinholeIntrinsics.primesense_default()
    depths = [read_depth_png(p) if isinstance(p, str) else np.asarray(p) for p in depth_paths]
    colors = None
    if color_paths is not None:
        colors = [read_intensity_png(p) if isinstance(p, str) else np.asarray(p)
                  for p in color_paths]
        assert len(colors) == len(depths)
    depths_t = [torch.as_tensor(d).to(dev, torch.float32) for d in depths]
    colors_t = None if colors is None else [torch.as_tensor(c).to(dev, torch.float32)
                                            for c in colors]

    def track(i, j, init=None):
        if colors_t is None:
            return depth_odometry(depths_t[i], depths_t[j], intr, init_trans=init, device=dev)
        return rgbd_odometry(colors_t[i], depths_t[i], colors_t[j], depths_t[j], intr,
                             init_trans=init, device=dev)

    # odometry chain + keyframe edges -> the fragment's pose graph
    poses = [np.eye(4)]
    edges = []
    for i in range(len(depths) - 1):
        trans, _ = track(i, i + 1)
        trans = trans.cpu().numpy()
        # camera_i -> camera_{i+1}; node poses are cam -> fragment (= cam_0)
        poses.append(poses[-1] @ np.linalg.inv(trans))
        edges.append(PoseGraphEdge(i, i + 1, np.linalg.inv(trans), np.eye(6), uncertain=False))
    for i in range(0, len(depths) - keyframe_every, keyframe_every):
        j = i + keyframe_every
        init = np.linalg.inv(np.linalg.inv(poses[j]) @ poses[i])
        trans, frac = track(i, j, init=torch.as_tensor(np.linalg.inv(init), dtype=torch.float32))
        if float(frac) > 0.3:
            edges.append(PoseGraphEdge(i, j, np.linalg.inv(trans.cpu().numpy()), np.eye(6),
                                       uncertain=True))
    if len(poses) > 1:
        graph = optimize_pose_graph(PoseGraph(poses=poses, edges=edges),
                                    max_correspondence_distance=0.07, device=dev)
        poses = [np.asarray(p) for p in graph.poses]

    # the volume centered on the first frame's backprojected points
    # (fragment frame == camera 0 frame)
    pts0, valid0 = backproject_depth(depths_t[0], intr, depth_trunc=depth_trunc)
    pts0 = pts0[valid0].cpu().numpy()
    vol_extent = np.asarray(grid_dims) * voxel_size
    if len(pts0):
        center = 0.5 * (pts0.min(0) + pts0.max(0))
    else:
        center = np.array([0.0, 0.0, vol_extent[2] / 2])
    origin = center - vol_extent / 2
    vol = TSDFVolume(origin=origin, voxel_size=voxel_size, sdf_trunc=sdf_trunc, dims=grid_dims,
                     device=dev)
    for depth, pose in zip(depths_t, poses):
        vol.integrate(depth, intr, np.asarray(pose, np.float32))
    return extract_surface_points(vol), poses


def make_fragments(dataset_dir: str, out_dir: str, n_frames_per_fragment: int = 100,
                   voxel_size: float = 0.008, fpfh_voxel: float = 0.05,
                   intr: PinholeIntrinsics | None = None, device: str | torch.device = "cuda"):
    """Process a scene directory with a ``depth/`` subfolder of 16-bit PNGs.
    An ``image/`` (or ``rgb/``, ``color/``) subfolder of as many color frames
    switches tracking to the hybrid photometric + geometric objective. The
    FPFH of each fragment runs on ``device``."""
    from pointdsc_tpu_torch.data.ply import write_ply_xyz
    from pointdsc_tpu_torch.descriptors.fpfh import extract_fpfh

    dev = resolve_device(device)
    depth_files = sorted(glob.glob(os.path.join(dataset_dir, "depth", "*.png")))
    color_files = None
    for sub in ("image", "rgb", "color"):
        cand = sorted(glob.glob(os.path.join(dataset_dir, sub, "*.png"))
                      + glob.glob(os.path.join(dataset_dir, sub, "*.jpg")))
        if len(cand) == len(depth_files) and cand:
            color_files = cand
            break
    os.makedirs(out_dir, exist_ok=True)
    n_fragments = int(np.ceil(len(depth_files) / n_frames_per_fragment))
    world_pose = np.eye(4)
    for f in range(n_fragments):
        sl = slice(f * n_frames_per_fragment, (f + 1) * n_frames_per_fragment)
        chunk = depth_files[sl]
        cchunk = color_files[sl] if color_files else None
        points, poses = build_fragment(chunk, intr=intr, voxel_size=voxel_size,
                                       color_paths=cchunk, device=dev)
        write_ply_xyz(os.path.join(out_dir, f"fragment_{f:03d}.ply"), points)
        np.save(os.path.join(out_dir, f"fragment_{f:03d}.npy"), world_pose)
        keypts, feats = extract_fpfh(points, voxel_size=fpfh_voxel, device=dev)
        np.savez(os.path.join(out_dir, f"fragment_{f:03d}_fpfh.npz"), xyz=keypts, feature=feats)
        # advance the world pose by the fragment's internal motion
        world_pose = world_pose @ poses[-1]
        print(f"fragment {f}: {len(points)} surface points")
