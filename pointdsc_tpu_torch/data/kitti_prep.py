"""KITTI odometry pairs and their ground truth (the port's own copy of
``pointdsc_tpu/data/kitti_prep.py``; the reference's misc/cal_fcgf.py:198-340,
``process_kitti``, without MinkowskiEngine or Open3D).

Frame pairs are selected from the odometry poses, the camera-frame odometry
is mapped into the velodyne frame with the standard velodyne-to-camera
extrinsics, the ground truth is refined by ICP on 5 cm voxelised clouds
(cached as ``icp/<drive>_<t0>_<t1>.npy``, like the reference) and both
clouds are described by FPFH. Each pair is written as the ``.npz`` that
``KITTIDataset`` reads (keys xyz0, xyz1, features0, features1, gt_trans).
FPFH and ICP run on ``device``: on the card ICP's nearest-neighbour search
is the kernel of ``kernels/nn_search.py``.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.data.threedmatch import SPLIT_DIR
from pointdsc_tpu_torch.descriptors.fpfh import extract_fpfh, voxel_downsample
from pointdsc_tpu_torch.ops.icp import icp_point_to_point

# KITTI velodyne -> camera extrinsics (public calibration constants, also
# hard-coded by the reference at cal_fcgf.py:225-231)
_R = np.array([
    7.533745e-03, -9.999714e-01, -6.166020e-04,
    1.480249e-02, 7.280733e-04, -9.998902e-01,
    9.998621e-01, 7.523790e-03, 1.480755e-02,
]).reshape(3, 3)
_T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01]).reshape(3, 1)
VELO2CAM = np.vstack([np.hstack([_R, _T]), [0, 0, 0, 1]]).T  # transposed form


def load_odometry_poses(root: str, drive_id: int) -> np.ndarray:
    """``poses/XX.txt`` as [n, 4, 4] camera poses."""
    data = np.loadtxt(os.path.join(root, "poses", f"{drive_id:02d}.txt")).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (data.shape[0], 1, 1))
    poses[:, :3, :] = data
    return poses


def select_pairs(positions: np.ndarray, frame_ids: list[int],
                 min_dist: float = 10.0) -> list[tuple[int, int]]:
    """The reference's greedy selection (cal_fcgf.py:250-266): from each start
    frame, the frame just before the first one of the next 100 whose camera
    lies more than ``min_dist`` away; the next search starts after it."""
    Ts = positions[:, :3, 3]
    pdist = np.sqrt(((Ts[None] - Ts[:, None]) ** 2).sum(-1))
    more_than = pdist > min_dist
    ids = set(frame_ids)
    pairs = []
    curr = frame_ids[0]
    while curr in ids:
        nxt = np.where(more_than[curr][curr:curr + 100])[0]
        if len(nxt) == 0:
            curr += 1
            continue
        nxt = int(nxt[0]) + curr - 1
        if nxt in ids:
            pairs.append((curr, nxt))
            curr = nxt + 1
        else:
            curr += 1
    return pairs


def velodyne_pair_gt(pose0: np.ndarray, pose1: np.ndarray) -> np.ndarray:
    """The initial transform from frame 0's velodyne coordinates to frame 1's,
    from the camera odometry (cal_fcgf.py:295-297):
    M = (velo2cam @ P0^T @ inv(P1^T) @ inv(velo2cam))^T."""
    return (VELO2CAM @ pose0.T @ np.linalg.inv(pose1.T) @ np.linalg.inv(VELO2CAM)).T


def read_velodyne_bin(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]


def _save_atomic(path: str, save) -> None:
    """Write through a temporary name, so that an interrupted run leaves no
    partial file for the next run to take as done."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        save(f)
    os.replace(tmp, path)


def process_kitti(root: str, out_dir: str, split: str = "train", split_dir: str | None = None,
                  min_dist: float = 10.0, voxel_size: float = 0.30, icp_voxel: float = 0.05,
                  descriptor: str = "fpfh", drop_pairs=((8, 15, 58),),
                  device: str | torch.device = "cuda"):
    """Build the ``{descriptor}_{split}`` pair directory for KITTIDataset from
    ``{root}/sequences/XX/velodyne/*.bin`` and ``{root}/poses/XX.txt``. A
    pair already written is skipped; a cached ICP result is reused, and a
    new one is cached only once its fit has given a finite transform."""
    dev = resolve_device(device)
    with open(os.path.join(split_dir or SPLIT_DIR, f"{split}_kitti.txt")) as f:
        subset = f.read().split()

    pair_dir = os.path.join(out_dir, f"{descriptor}_{split}")
    icp_dir = os.path.join(out_dir, "icp")
    os.makedirs(pair_dir, exist_ok=True)
    os.makedirs(icp_dir, exist_ok=True)
    dropped = set(drop_pairs)

    for name in subset:
        drive = int(name)
        velo_dir = os.path.join(root, "sequences", f"{drive:02d}", "velodyne")
        frame_ids = sorted(int(os.path.basename(f)[:-4])
                           for f in glob.glob(os.path.join(velo_dir, "*.bin")))
        poses = load_odometry_poses(root, drive)
        pairs = [p for p in select_pairs(poses, frame_ids, min_dist)
                 if (drive, p[0], p[1]) not in dropped]

        for t0, t1 in pairs:
            key = f"{drive}_{t0}_{t1}"
            out_path = os.path.join(pair_dir, f"pair_{key}.npz")
            if os.path.exists(out_path):
                continue
            xyz0 = read_velodyne_bin(os.path.join(velo_dir, f"{t0:06d}.bin"))
            xyz1 = read_velodyne_bin(os.path.join(velo_dir, f"{t1:06d}.bin"))

            icp_path = os.path.join(icp_dir, f"{key}.npy")
            if os.path.exists(icp_path):
                gt = np.load(icp_path)
            else:
                M = velodyne_pair_gt(poses[t0], poses[t1])
                d0, d1 = (torch.as_tensor(voxel_downsample(x.astype(np.float64), icp_voxel),
                                          device=dev) for x in (xyz0, xyz1))
                refined, _, _ = icp_point_to_point(
                    d0, d1, torch.as_tensor(M, dtype=torch.float32, device=dev),
                    max_correspondence_distance=0.2, max_iters=200)
                gt = refined.cpu().numpy()
                if not np.isfinite(gt).all():
                    raise RuntimeError(f"ICP of pair {key} gave a non-finite transform")
                _save_atomic(icp_path, lambda f: np.save(f, gt))

            k0, f0 = extract_fpfh(xyz0, voxel_size=voxel_size, device=dev)
            k1, f1 = extract_fpfh(xyz1, voxel_size=voxel_size, device=dev)
            _save_atomic(out_path, lambda f: np.savez(f, xyz0=k0, xyz1=k1, features0=f0,
                                                       features1=f1, gt_trans=gt))
            print(f"wrote {out_path} ({len(k0)}/{len(k1)} pts)")
