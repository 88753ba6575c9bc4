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


def seed_stage_inputs(n: int, batch: int = 1, kitti: bool = False, seed: int = 0,
                      channels: int = 128, pad_fraction: float = 0.05) -> dict:
    """Inputs of the seed stage after the seed k-NN (``kernels/scoring.py``)
    at N = n, as numpy arrays: half the points inliers of a rigid motion (a
    2 m cube, noise 0.01 m, sigma_d 0.1, threshold 0.1; with ``kitti`` a
    100 m cube, noise 0.2 m, sigma_d 1.2, threshold 0.6), the last
    ``pad_fraction`` of each sample padded (``mask``); unit features with the
    inliers near one direction; S = n / 10 seeds among the valid inliers, as
    a trained model's NMS picks confident points. An outlier seed among
    these random features can be nearly degenerate (Horn's two leading
    eigenvalues close), and then two f32 orders of its sums differ beyond a
    fixed tolerance: such seeds are held to an f64 run within a tolerance
    scaled by their conditioning (``kernels/scoring.py::seed_trans_reference``)."""
    rng = np.random.default_rng(seed)
    s, scale = n // 10, 50.0 if kitti else 1.0
    src = rng.uniform(-1.0, 1.0, (batch, n, 3)) * scale
    tgt = np.empty_like(src)
    feats = rng.normal(size=(batch, n, channels))
    base = rng.normal(size=channels)
    mask = np.broadcast_to(np.arange(n) < n - int(n * pad_fraction), (batch, n)).copy()
    seeds = np.empty((batch, s), np.int64)
    for b in range(batch):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        tgt[b] = src[b] @ (q * np.sign(np.linalg.det(q))).T + rng.normal(size=3) * 0.3 * scale
        tgt[b] += rng.normal(size=(n, 3)) * (0.2 if kitti else 0.01)
        out = rng.uniform(size=n) < 0.5
        tgt[b, out] = rng.uniform(-1.0, 1.0, (int(out.sum()), 3)) * scale
        feats[b, ~out] = base + 0.6 * rng.normal(size=(int((~out).sum()), channels))
        seeds[b] = rng.permutation(np.flatnonzero(mask[b] & ~out))[:s]
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    return dict(feats=feats.astype(np.float32), src=src.astype(np.float32),
                tgt=tgt.astype(np.float32), mask=mask, seeds=seeds,
                sigma_d=1.2 if kitti else 0.1, inlier_threshold=0.6 if kitti else 0.1)
