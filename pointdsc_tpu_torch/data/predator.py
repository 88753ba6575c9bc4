"""Predator-correspondence loader for the 3DLoMatch benchmark (the port's
own copy of ``pointdsc_tpu/data/predator.py``).

The reference's ``get_predator_data`` (its evaluation/test_3DLoMatch.py:22-60):
per-pair ``.pth`` dictionaries (pcd, feats, saliency, overlaps, rot, trans)
written by OverlapPredator, each cloud sampled to ``n_points`` with
probabilities overlap x saliency, without replacement, and matched by the
argmax of the descriptors' inner product.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pointdsc_tpu_torch.data import transforms_np as T
from pointdsc_tpu_torch.data.pipeline import make_corr_pos


def load_predator_pair(path: str, n_points: int = 5000, inlier_threshold: float = 0.10,
                       in_dim: int = 6, rng: np.random.Generator | None = None) -> dict:
    """One Predator pair file as the standard sample dict (numpy)."""
    rng = rng or np.random.default_rng()
    data = torch.load(path, map_location="cpu", weights_only=False)
    len_src = int(data["len_src"])
    pcd = data["pcd"].numpy()
    feats = data["feats"].numpy()
    src_pcd, tgt_pcd = pcd[:len_src], pcd[len_src:]
    src_feats, tgt_feats = feats[:len_src], feats[len_src:]
    saliency = np.asarray(data["saliency"]).reshape(-1)
    overlap = np.asarray(data["overlaps"]).reshape(-1)
    src_scores = overlap[:len_src] * saliency[:len_src]
    tgt_scores = overlap[len_src:] * saliency[len_src:]

    def subsample(pcd_, feats_, scores):
        if pcd_.shape[0] > n_points:
            probs = scores / scores.sum()
            idx = rng.choice(pcd_.shape[0], n_points, replace=False, p=probs)
            return pcd_[idx], feats_[idx]
        return pcd_, feats_

    src_pcd, src_feats = subsample(src_pcd, src_feats, src_scores)
    tgt_pcd, tgt_feats = subsample(tgt_pcd, tgt_feats, tgt_scores)

    source_idx = np.argmax(src_feats @ tgt_feats.T, axis=-1)
    input_src = src_pcd
    input_tgt = tgt_pcd[source_idx]

    gt_trans = T.integrate_trans(np.asarray(data["rot"], dtype=np.float64),
                                 np.asarray(data["trans"], dtype=np.float64))
    warped = T.transform(input_src, gt_trans)
    labels = (np.linalg.norm(warped - input_tgt, axis=-1) < inlier_threshold).astype(np.float32)

    corr_pos = make_corr_pos(input_src, input_tgt, in_dim)
    return {
        "corr_pos": corr_pos.astype(np.float32),
        "src_keypts": input_src.astype(np.float32),
        "tgt_keypts": input_tgt.astype(np.float32),
        "gt_trans": gt_trans.astype(np.float32),
        "gt_labels": labels,
    }


class PredatorLoMatchDataset:
    """The 1781 3DLoMatch pairs of a Predator output directory of
    ``{index}.pth`` files."""

    def __init__(self, root: str, n_points: int = 5000, inlier_threshold: float = 0.10,
                 in_dim: int = 6, num_pairs: int = 1781, seed: int = 51):
        self.root = root
        self.n_points = n_points
        self.inlier_threshold = inlier_threshold
        self.in_dim = in_dim
        self.num_pairs = num_pairs
        self.seed = seed

    def __len__(self):
        return self.num_pairs

    def __getitem__(self, index: int) -> dict:
        return load_predator_pair(
            os.path.join(self.root, f"{index}.pth"), n_points=self.n_points,
            inlier_threshold=self.inlier_threshold, in_dim=self.in_dim,
            rng=np.random.default_rng((self.seed, index)))
