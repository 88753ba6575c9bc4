"""Redwood / Augmented ICL-NUIM fragment dataset, the multiway registration
input (the port's own copy of ``pointdsc_tpu/data/redwood.py``; numpy).

File-format compatible with the reference RedwoodDataset (datasets/Redwood.py:
9-223): a scene's ``fragments/`` directory holds ``fragment_XXX_{fpfh,fcgf}.npz``
descriptor files and the ``fragment_XXX.npy`` ground-truth poses (fragment ->
world); a pair's ground truth is inv(pose_j) @ pose_i. Each sample carries the
extra ``key`` ("scene@i_j") the multiway pipeline reads.
"""

from __future__ import annotations

import os

import numpy as np

from pointdsc_tpu_torch.data.pipeline import build_correspondences

REDWOOD_SCENES = [
    "livingroom1-simulated",
    "livingroom2-simulated",
    "office1-simulated",
    "office2-simulated",
]


class RedwoodDataset:
    def __init__(self, root: str, select_scene: str, descriptor: str = "fpfh", in_dim: int = 6,
                 inlier_threshold: float = 0.10, num_node=5000, use_mutual: bool = True,
                 seed: int = 51, device: str = "cuda"):
        """``device`` is where the ``in_dim=12`` normals are estimated."""
        assert descriptor in ("fcgf", "fpfh")
        self.root = root
        self.scene = select_scene
        self.descriptor = descriptor
        self.in_dim = in_dim
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.seed = seed
        self.device = device

        frag_dir = os.path.join(root, select_scene, "fragments")
        # fragments in the order of the number in their name
        pcd_list = sorted((f for f in os.listdir(frag_dir) if f.endswith("npz")),
                          key=lambda x: int(x[:-4].split("_")[-2]))
        self.num_pcds = int(pcd_list[-1][:-4].split("_")[-2]) + 1

        self.gt_trajectory = [  # fragment -> world poses
            np.load(os.path.join(frag_dir, f"fragment_{str(i).zfill(3)}.npy"))
            for i in range(self.num_pcds)]
        self.keys = []
        self.gt_trans = {}
        for i in range(self.num_pcds):
            for j in range(i + 1, self.num_pcds):
                key = f"{select_scene}@{i}_{j}"
                self.keys.append(key)
                self.gt_trans[key] = (np.linalg.inv(self.gt_trajectory[j])
                                      @ self.gt_trajectory[i])

    def __len__(self):
        return len(self.keys)

    def pair_ids(self, index: int) -> tuple[int, int]:
        _, pair = self.keys[index].split("@")
        i, j = pair.split("_")
        return int(i), int(j)

    def _load(self, frag_id: int):
        path = os.path.join(self.root, self.scene, "fragments",
                            f"fragment_{str(frag_id).zfill(3)}_{self.descriptor}.npz")
        data = np.load(path)
        xyz, feat = data["xyz"], data["feature"]
        if self.descriptor == "fpfh":
            feat = feat / (np.linalg.norm(feat, axis=1, keepdims=True) + 1e-6)
        return xyz, feat

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng((self.seed, index))
        src_id, tgt_id = self.pair_ids(index)
        src_xyz, src_feat = self._load(src_id)
        tgt_xyz, tgt_feat = self._load(tgt_id)
        # the reference samples without replacement only when the cloud is
        # larger than num_node (Redwood.py:155-158): build_correspondences' rule
        sample = build_correspondences(src_xyz, tgt_xyz, src_feat, tgt_feat,
                                       self.gt_trans[self.keys[index]], self.inlier_threshold,
                                       num_node=self.num_node, use_mutual=self.use_mutual,
                                       in_dim=self.in_dim, rng=rng, device=self.device)
        sample["key"] = self.keys[index]
        return sample
