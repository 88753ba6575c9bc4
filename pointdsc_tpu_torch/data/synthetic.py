"""Synthetic registration pairs: planted rigid transforms + outliers (the
port's own copy of ``pointdsc_tpu/data/synthetic.py``; the same seed gives
the same arrays)."""

from __future__ import annotations

import numpy as np

from pointdsc_tpu_torch.data import transforms_np as T
from pointdsc_tpu_torch.data.pipeline import make_corr_pos


class SyntheticPairDataset:
    def __init__(
        self,
        num_pairs: int = 64,
        num_corr: int = 1000,
        inlier_ratio: float = 0.4,
        noise: float = 0.005,
        in_dim: int = 6,
        inlier_threshold: float = 0.10,
        scene_scale: float = 1.5,
        seed: int = 0,
    ):
        self.num_pairs = num_pairs
        self.num_corr = num_corr
        self.inlier_ratio = inlier_ratio
        self.noise = noise
        self.in_dim = in_dim
        self.inlier_threshold = inlier_threshold
        self.scene_scale = scene_scale
        self.seed = seed

    def __len__(self):
        return self.num_pairs

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + index)
        n = self.num_corr

        R = T.rotation_matrix(3, 1.0, rng)
        t = T.translation_matrix(0.5, rng)
        gt_trans = T.integrate_trans(R, t)

        src = rng.uniform(-self.scene_scale, self.scene_scale, size=(n, 3))
        tgt = T.transform(src, gt_trans) + rng.normal(size=(n, 3)) * self.noise

        n_out = int(n * (1.0 - self.inlier_ratio))
        out_idx = rng.choice(n, n_out, replace=False)
        tgt[out_idx] = rng.uniform(-self.scene_scale, self.scene_scale, size=(n_out, 3))

        warped = T.transform(src, gt_trans)
        labels = (
            np.linalg.norm(warped - tgt, axis=-1) < self.inlier_threshold
        ).astype(np.float32)

        corr_pos = make_corr_pos(src, tgt, self.in_dim)
        return {
            "corr_pos": corr_pos.astype(np.float32),
            "src_keypts": src.astype(np.float32),
            "tgt_keypts": tgt.astype(np.float32),
            "gt_trans": gt_trans.astype(np.float32),
            "gt_labels": labels,
        }
