"""KITTI odometry pair dataset (the port's own copy of
``pointdsc_tpu/data/kitti.py``).

The reference's layout (its datasets/KITTI.py:6-137): one ``.npz`` per pair
under ``{root}/{descriptor}_{split}/`` with keys xyz0, xyz1, features0,
features1, gt_trans; a 0.05 m jitter on the train split only. A sample is
the JAX package's array for array. ``device`` is where
``build_correspondences`` estimates the ``in_dim=12`` normals.
"""

from __future__ import annotations

import os

import numpy as np

from pointdsc_tpu_torch.data import transforms_np as T
from pointdsc_tpu_torch.data.pipeline import build_correspondences


class KITTIDataset:
    def __init__(self, root: str, split: str = "train", descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.60, num_node=5000, use_mutual: bool = True,
                 augment_axis: int = 0, augment_rotation: float = 1.0,
                 augment_translation: float = 0.01, seed: int = 0, device: str = "cuda"):
        assert descriptor in ("fcgf", "fpfh")
        self.root = root
        self.split = split
        self.descriptor = descriptor
        self.in_dim = in_dim
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.augment_axis = augment_axis
        self.augment_rotation = augment_rotation
        self.augment_translation = augment_translation
        self.seed = seed
        self.device = device

        pair_dir = os.path.join(root, f"{descriptor}_{split}")
        self.ids_list = [os.path.join(pair_dir, fn) for fn in sorted(os.listdir(pair_dir))]

    def __len__(self):
        return len(self.ids_list)

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng((self.seed, index))
        data = np.load(self.ids_list[index])
        src_xyz, tgt_xyz = data["xyz0"], data["xyz1"]
        src_feat, tgt_feat = data["features0"], data["features1"]
        if self.descriptor == "fpfh":
            src_feat = src_feat / (np.linalg.norm(src_feat, axis=1, keepdims=True) + 1e-6)
            tgt_feat = tgt_feat / (np.linalg.norm(tgt_feat, axis=1, keepdims=True) + 1e-6)

        orig_trans = np.asarray(data["gt_trans"], dtype=np.float64)
        jitter = 0.05 if self.split == "train" else 0.0
        src_xyz, tgt_xyz, gt_trans = T.augment_pair(
            src_xyz, tgt_xyz, orig_trans, self.augment_axis, self.augment_rotation,
            self.augment_translation, jitter, rng)
        return build_correspondences(
            src_xyz, tgt_xyz, src_feat, tgt_feat, gt_trans, self.inlier_threshold,
            num_node=self.num_node, use_mutual=self.use_mutual, in_dim=self.in_dim, rng=rng,
            device=self.device)
