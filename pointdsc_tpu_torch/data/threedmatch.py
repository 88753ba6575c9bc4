"""3DMatch dataset readers: train/val pairs, the 8 test scenes, 3DLoMatch (the
port's own copy of ``pointdsc_tpu/data/threedmatch.py``).

The reference's file layout (its datasets/ThreeDMatch.py):
fragment ``.npz`` files with keys ``xyz`` and ``feature``, the split txt
files, ``gt_result/<scene>-evaluation/gt.log`` and the 3DLoMatch pickle. A
sample is the JAX package's array for array: the same seeded generator,
drawn in the same order, the same float64 and float32 steps. ``device`` is
where ``build_correspondences`` estimates the ``in_dim=12`` normals.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from pointdsc_tpu_torch.data import transforms_np as T
from pointdsc_tpu_torch.data.pipeline import build_correspondences

SPLIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "splits")

TEST_SCENES = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]


def load_gt_log(gt_path: str) -> dict:
    """Parse a Redwood-format ``gt.log``: blocks of one tab-separated header
    line (i j n) and four matrix rows (reference ThreeDMatch.py:338-352).
    Returns {"i_j": [4, 4] float64}."""
    with open(os.path.join(gt_path, "gt.log")) as f:
        lines = f.readlines()
    result = {}
    for i in range(0, len(lines), 5):
        header = lines[i].replace("\n", "").split("\t")[0:3]
        trans = np.array([[float(v) for v in lines[i + 1 + r].split()] for r in range(4)])
        result[f"{int(header[0])}_{int(header[1])}"] = trans
    return result


def _load_fragment(path_base: str, descriptor: str):
    data = np.load(f"{path_base}_{descriptor}.npz")
    xyz, feat = data["xyz"], data["feature"]
    if descriptor == "fpfh":
        feat = np.nan_to_num(feat)
        feat = feat / (np.linalg.norm(feat, axis=1, keepdims=True) + 1e-6)
    return xyz, feat


class ThreeDMatchTrainVal:
    """Training/validation pairs with augmentation (reference
    ThreeDMatchTrainVal, ThreeDMatch.py:10-177): the pairs of every list file
    ``threedmatch/{scene}*{overlap:.2f}.txt`` of the split's scenes."""

    def __init__(self, root: str, split: str, descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.10, num_node: int = 1000, use_mutual: bool = False,
                 augment_axis: int = 3, augment_rotation: float = 1.0,
                 augment_translation: float = 0.5, jitter: float = 0.005,
                 overlap_ratio: float = 0.30, split_dir: str | None = None, seed: int = 0,
                 device: str = "cuda"):
        assert descriptor in ("fpfh", "fcgf")
        self.root = root
        self.descriptor = descriptor
        self.in_dim = in_dim
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.augment_axis = augment_axis
        self.augment_rotation = augment_rotation
        self.augment_translation = augment_translation
        self.jitter = jitter
        self.seed = seed
        self.device = device

        split_file = os.path.join(split_dir or SPLIT_DIR, f"{split}_3dmatch.txt")
        with open(split_file) as f:
            subset_names = f.read().split()
        self.files: list[tuple[str, str]] = []
        for name in subset_names:
            pattern = os.path.join(root, "threedmatch", f"{name}*{overlap_ratio:.2f}.txt")
            for txt in sorted(glob.glob(pattern)):
                with open(txt) as f:
                    pairs = [line.strip().split() for line in f.readlines()]
                self.files.extend((p[0], p[1]) for p in pairs)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng((self.seed, index))
        src_id, tgt_id = self.files[index]
        if rng.random() > 0.5:
            src_id, tgt_id = tgt_id, src_id

        base = os.path.join(self.root, "threedmatch_feat")
        src_xyz, src_feat = _load_fragment(os.path.join(base, src_id.replace(".npz", "")),
                                           self.descriptor)
        tgt_xyz, tgt_feat = _load_fragment(os.path.join(base, tgt_id.replace(".npz", "")),
                                           self.descriptor)
        src_xyz, tgt_xyz, gt_trans = T.augment_pair(
            src_xyz, tgt_xyz, np.eye(4, dtype=np.float32), self.augment_axis,
            self.augment_rotation, self.augment_translation, self.jitter, rng)
        # the reference samples 3DMatch training keypoints with replacement
        # (ThreeDMatch.py:103-104, np.random.choice's default)
        return build_correspondences(
            src_xyz, tgt_xyz, src_feat, tgt_feat, gt_trans, self.inlier_threshold,
            num_node=self.num_node, use_mutual=self.use_mutual, in_dim=self.in_dim, rng=rng,
            sample_replace=True, device=self.device)


class ThreeDMatchTest:
    """The 8-scene 3DMatch test benchmark (reference ThreeDMatchTest,
    ThreeDMatch.py:180-352). Only scenes with a ``gt.log`` are read; the
    stored transforms are target -> source and are inverted at load
    (ThreeDMatch.py:259)."""

    def __init__(self, root: str, descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.10, num_node="all", use_mutual: bool = False,
                 select_scene: str | None = None, seed: int = 51, device: str = "cuda"):
        self.root = root
        self.descriptor = descriptor
        self.in_dim = in_dim
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.seed = seed
        self.device = device

        scene_list = [select_scene] if select_scene in TEST_SCENES else list(TEST_SCENES)
        self.scene_list = [
            s for s in scene_list
            if os.path.exists(os.path.join(root, "gt_result", f"{s}-evaluation", "gt.log"))]
        if not self.scene_list:
            raise FileNotFoundError(f"no gt_result/<scene>-evaluation/gt.log found under {root}")
        self.gt_trans: dict[str, np.ndarray] = {}
        for scene in self.scene_list:
            gt_path = os.path.join(root, "gt_result", f"{scene}-evaluation")
            for key, trans in load_gt_log(gt_path).items():
                self.gt_trans[f"{scene}@{key}"] = trans
        self.keys = list(self.gt_trans.keys())

    def __len__(self):
        return len(self.keys)

    def scene_of(self, index: int) -> int:
        return self.scene_list.index(self.keys[index].split("@")[0])

    def __getitem__(self, index: int) -> dict:
        key = self.keys[index]
        scene, pair = key.split("@")
        src_id, tgt_id = pair.split("_")

        base = os.path.join(self.root, "fragments", scene)
        src_xyz, src_feat = _load_fragment(os.path.join(base, f"cloud_bin_{src_id}"),
                                           self.descriptor)
        tgt_xyz, tgt_feat = _load_fragment(os.path.join(base, f"cloud_bin_{tgt_id}"),
                                           self.descriptor)
        gt_trans = np.linalg.inv(self.gt_trans[key])

        rng = np.random.default_rng((self.seed, index))
        return build_correspondences(
            src_xyz, tgt_xyz, src_feat, tgt_feat, gt_trans, self.inlier_threshold,
            num_node=self.num_node, use_mutual=self.use_mutual, in_dim=self.in_dim, rng=rng,
            sample_replace=True, device=self.device)  # ThreeDMatch.py:275-276


class ThreeDLoMatchTest:
    """The 3DLoMatch low-overlap benchmark (1781 pairs), driven by the
    reference's ``3DLoMatch.pkl`` (fields ``rot``, ``trans``, ``src``,
    ``tgt``; ThreeDMatch.py:354-456)."""

    def __init__(self, root: str, descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.10, num_node=5000, use_mutual: bool = False,
                 pickle_path: str | None = None, seed: int = 51, device: str = "cuda"):
        self.root = root
        self.descriptor = descriptor
        self.in_dim = in_dim
        self.inlier_threshold = inlier_threshold
        self.num_node = num_node
        self.use_mutual = use_mutual
        self.seed = seed
        self.device = device

        with open(pickle_path or os.path.join(root, "3DLoMatch.pkl"), "rb") as f:
            self.infos = pickle.load(f)

    def __len__(self):
        return len(self.infos["rot"])

    def __getitem__(self, index: int) -> dict:
        gt_trans = T.integrate_trans(self.infos["rot"][index], self.infos["trans"][index])
        scene = self.infos["src"][index].split("/")[1]
        src_id, tgt_id = (self.infos[k][index].split("/")[-1].split("_")[-1].replace(".pth", "")
                          for k in ("src", "tgt"))

        base = os.path.join(self.root, "fragments", scene)
        src_xyz, src_feat = _load_fragment(os.path.join(base, f"cloud_bin_{src_id}"),
                                           self.descriptor)
        tgt_xyz, tgt_feat = _load_fragment(os.path.join(base, f"cloud_bin_{tgt_id}"),
                                           self.descriptor)
        rng = np.random.default_rng((self.seed, index))
        return build_correspondences(
            src_xyz, tgt_xyz, src_feat, tgt_feat, gt_trans, self.inlier_threshold,
            num_node=self.num_node, use_mutual=self.use_mutual, in_dim=self.in_dim, rng=rng,
            sample_replace=True, device=self.device)  # ThreeDMatch.py:419-420
