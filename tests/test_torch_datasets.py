"""The port's dataset loaders (``pointdsc_tpu_torch/data``) against the JAX
package's on fake data roots in the reference's file layouts, written by the
JAX tests' own writers (``write_fake_root``, ``write_fake_kitti``,
``write_fake_train_root``), with an FPFH variant of each root, a 3DLoMatch
pickle, OverlapPredator ``.pth`` files in ``test_predator_loader.py``'s
layout, and a dense indoor root for the ``in_dim=12`` normals.

Tolerances: every key of ``dataset[i]`` is equal bit for bit
(``np.testing.assert_array_equal``): the seeded generator is drawn in the
same order and every step is the same numpy operation. The one exception is
the normals of ``in_dim=12``, which each package estimates with its own
framework: those six columns within 1e-4 (``test_torch_fpfh.py``'s bound for
``estimate_normals``) on 99.5% of the rows (``assert_normals_close`` says
why not all), the coordinates beside them bit for bit.
``process_kitti``: keypoints bit for bit, the ICP-refined ``gt_trans``
within 1e-4, FPFH features as ``test_torch_fpfh.py`` holds them.
"""

import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
sys.path.insert(0, ROOT)
sys.path.insert(0, TESTS)

from chip_smoke import (  # noqa: E402
    make_scene,
    write_fake_drive,
    write_lomatch_pickle,
    write_predator_pair,
)
from pointdsc_tpu.data import kitti as j_kitti  # noqa: E402
from pointdsc_tpu.data import kitti_prep as j_prep  # noqa: E402
from pointdsc_tpu.data import predator as j_predator  # noqa: E402
from pointdsc_tpu.data import stats as j_stats  # noqa: E402
from pointdsc_tpu.data import threedmatch as j_3dm  # noqa: E402
from pointdsc_tpu.data import transforms_np as j_T  # noqa: E402
from pointdsc_tpu.descriptors import fpfh as j_fpfh  # noqa: E402
from pointdsc_tpu_torch.data import kitti as t_kitti  # noqa: E402
from pointdsc_tpu_torch.data import kitti_prep as t_prep  # noqa: E402
from pointdsc_tpu_torch.data import predator as t_predator  # noqa: E402
from pointdsc_tpu_torch.data import stats as t_stats  # noqa: E402
from pointdsc_tpu_torch.data import threedmatch as t_3dm  # noqa: E402
from pointdsc_tpu_torch.data import transforms_np as t_T  # noqa: E402
from pointdsc_tpu_torch.descriptors import fpfh as t_fpfh  # noqa: E402
from test_eval_cli_integration import SCENE, write_fake_root  # noqa: E402
from test_kitti_cli_integration import write_fake_kitti  # noqa: E402
from test_torch_fpfh import assert_fpfh_close  # noqa: E402
from test_train_cli_integration import SCENE as TRAIN_SCENE  # noqa: E402
from test_train_cli_integration import write_fake_train_root  # noqa: E402

NORMAL_ATOL = 1e-4


def add_fpfh_variant(directory, nan_rows=True, seed=0):
    """Beside every ``*_fcgf.npz`` fragment a ``*_fpfh.npz`` with the same
    points and 33-bin non-negative features (3DMatch's FPFH files may hold
    NaN, which the loader zeroes: a few rows get one)."""
    rng = np.random.default_rng(seed)
    for name in sorted(os.listdir(directory)):
        if not name.endswith("_fcgf.npz"):
            continue
        data = np.load(os.path.join(directory, name))
        feat = rng.uniform(0, 50, (len(data["xyz"]), 33)).astype(np.float32)
        if nan_rows:
            feat[rng.choice(len(feat), 3, replace=False), 5] = np.nan
        np.savez(os.path.join(directory, name.replace("_fcgf", "_fpfh")), xyz=data["xyz"],
                 feature=feat)


def write_predator_pairs(directory, rng, num_pairs=2, n_src=300, n_tgt=280):
    """OverlapPredator pair files ``{i}.pth`` in test_predator_loader.py's
    layout (the target a rigid copy of part of the source, the same unit
    features), with varied saliency and overlap scores, so that the weighted
    sampling matters."""
    os.makedirs(directory, exist_ok=True)
    for p in range(num_pairs):
        src = rng.uniform(-1, 1, (n_src, 3)).astype(np.float32)
        gt = j_T.integrate_trans(j_T.rotation_matrix(3, 1.0, rng),
                                 j_T.translation_matrix(0.3, rng))
        tgt = j_T.transform(src.astype(np.float64), gt).astype(np.float32)[:n_tgt]
        feats = rng.normal(size=(n_src, 16)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        write_predator_pair(os.path.join(directory, f"{p}.pth"), src, tgt, feats,
                            feats[:n_tgt], gt, rng)


def write_dense_root(root, seed=0):
    """A 3DMatch root whose two fragments are voxelised scans of a
    ``make_scene`` room (3 cm), dense enough that the 6 cm normals of
    ``in_dim=12`` are well defined on every point (``num_node="all"``; a
    sample of the keypoints leaves points with one or two neighbours, whose
    normal is any vector of a plane and differs between the packages):
    random unit features, a gt.log, and the same fragments as a training
    scene of ``write_fake_train_root``'s layout and split."""
    src, tgt, gt = make_scene(seed, n_points=6000, room=1.0, overlap_cut=(0.8, 0.24))
    rng = np.random.default_rng(seed)
    frag_dir = os.path.join(root, "fragments", SCENE)
    feat_dir = os.path.join(root, "threedmatch_feat")
    for d in (frag_dir, feat_dir, os.path.join(root, "threedmatch")):
        os.makedirs(d, exist_ok=True)
    for i, cloud in enumerate((src, tgt)):
        xyz = j_fpfh.voxel_downsample(cloud, 0.03)
        feat = rng.normal(size=(len(xyz), 32)).astype(np.float32)
        for path in (os.path.join(frag_dir, f"cloud_bin_{i}_fcgf.npz"),
                     os.path.join(feat_dir, f"{TRAIN_SCENE}_{i:03d}_fcgf.npz")):
            np.savez(path, xyz=xyz, feature=feat / np.linalg.norm(feat, axis=1, keepdims=True))
    with open(os.path.join(root, "threedmatch", f"{TRAIN_SCENE}@seq-01-0.30.txt"), "w") as f:
        f.write(f"{TRAIN_SCENE}_000.npz {TRAIN_SCENE}_001.npz 0.5\n"
                f"{TRAIN_SCENE}_001.npz {TRAIN_SCENE}_000.npz 0.5\n")
    gt_dir = os.path.join(root, "gt_result", f"{SCENE}-evaluation")
    os.makedirs(gt_dir, exist_ok=True)
    stored = np.linalg.inv(gt)  # the log stores tgt -> src
    with open(os.path.join(gt_dir, "gt.log"), "w") as f:
        f.write("0\t1\t2\n" + "".join("\t".join(f"{v:.8f}" for v in row) + "\n"
                                      for row in stored))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    out = {}
    rng = np.random.default_rng(51)

    out["test"] = str(base / "3dmatch")
    poses = write_fake_root(out["test"], rng, num_frag=3, n_pts=400)
    add_fpfh_variant(os.path.join(out["test"], "fragments", SCENE))
    write_lomatch_pickle(out["test"], SCENE, poses)

    out["train"] = str(base / "train")
    out["split_dir"] = write_fake_train_root(out["train"], rng, num_frag=5, n_pts=300)
    add_fpfh_variant(os.path.join(out["train"], "threedmatch_feat"))

    out["kitti"] = str(base / "kitti")
    write_fake_kitti(out["kitti"], rng, num_pairs=2, n_pts=400)
    os.rename(os.path.join(out["kitti"], "fcgf_test"), os.path.join(out["kitti"], "fcgf_train"))
    write_fake_kitti(out["kitti"], rng, num_pairs=3, n_pts=400)
    for split in ("train", "test"):  # FPFH pairs: the same points, 33 non-negative bins
        src_dir = os.path.join(out["kitti"], f"fcgf_{split}")
        dst_dir = os.path.join(out["kitti"], f"fpfh_{split}")
        os.makedirs(dst_dir)
        for name in sorted(os.listdir(src_dir)):
            d = dict(np.load(os.path.join(src_dir, name)))
            for key in ("features0", "features1"):
                d[key] = rng.uniform(0, 50, (len(d[key]), 33)).astype(np.float32)
            np.savez(os.path.join(dst_dir, name), **d)

    out["predator"] = str(base / "predator")
    write_predator_pairs(out["predator"], rng)

    out["dense"] = str(base / "dense")
    write_dense_root(out["dense"])
    return out


def assert_normals_close(out, ref):
    """Normals within NORMAL_ATOL on at least 99.5% of the rows, every one of
    unit length. A point whose neighbourhood is nearly degenerate (its two
    smallest covariance eigenvalues close) has an ill-conditioned normal,
    which two float32 eigen-solvers may turn apart: measured 3 rows of 2761 on
    a rotated cloud (0.05 off), none on the unrotated one."""
    close = (np.abs(out - ref) <= NORMAL_ATOL).all(axis=1)
    assert close.mean() >= 0.995, f"{(~close).sum()} of {len(close)} normals differ"
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def assert_samples_equal(out, ref, in_dim=6):
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].dtype == ref[key].dtype, key
        if key == "corr_pos" and in_dim == 12:
            # [src, src normal, tgt, tgt normal]
            for cols in (slice(0, 3), slice(6, 9)):
                np.testing.assert_array_equal(out[key][:, cols], ref[key][:, cols])
            for cols in (slice(3, 6), slice(9, 12)):
                assert_normals_close(out[key][:, cols], ref[key][:, cols])
        else:
            np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


# (loader name, root key, keyword arguments); the port's loaders also take
# device="cpu"
CASES = [
    ("trainval", "train", dict(split="train", descriptor="fcgf", num_node=128)),
    ("trainval", "train", dict(split="val", descriptor="fcgf", num_node=128)),
    ("trainval", "train", dict(split="train", descriptor="fpfh", num_node=128)),
    ("trainval", "train", dict(split="val", descriptor="fpfh", num_node=128,
                               use_mutual=True)),
    ("test", "test", dict(descriptor="fcgf")),
    ("test", "test", dict(descriptor="fpfh", num_node=256)),
    ("test", "test", dict(descriptor="fcgf", select_scene=SCENE, use_mutual=True)),
    ("lomatch", "test", dict(descriptor="fcgf", num_node=256)),
    ("lomatch", "test", dict(descriptor="fpfh", num_node="all")),
    ("kitti", "kitti", dict(split="train", descriptor="fcgf", num_node=300)),
    ("kitti", "kitti", dict(split="test", descriptor="fcgf", num_node=300)),
    ("kitti", "kitti", dict(split="train", descriptor="fpfh", num_node=500, augment_axis=1,
                            use_mutual=False)),
    ("kitti", "kitti", dict(split="test", descriptor="fpfh", num_node="all")),
    ("predator", "predator", dict(n_points=200)),
    ("predator", "predator", dict(n_points=400, in_dim=9)),
    ("test", "dense", dict(descriptor="fcgf", num_node="all", in_dim=12)),
    ("trainval", "dense", dict(split="train", descriptor="fcgf", num_node="all", in_dim=12)),
    ("trainval", "dense", dict(split="val", descriptor="fcgf", num_node="all", in_dim=12,
                               use_mutual=True)),
]
LOADERS = {
    "trainval": (j_3dm.ThreeDMatchTrainVal, t_3dm.ThreeDMatchTrainVal),
    "test": (j_3dm.ThreeDMatchTest, t_3dm.ThreeDMatchTest),
    "lomatch": (j_3dm.ThreeDLoMatchTest, t_3dm.ThreeDLoMatchTest),
    "kitti": (j_kitti.KITTIDataset, t_kitti.KITTIDataset),
    "predator": (j_predator.PredatorLoMatchDataset, t_predator.PredatorLoMatchDataset),
}


def make_pair(roots, loader, root_key, kwargs):
    j_cls, t_cls = LOADERS[loader]
    kw = dict(kwargs, root=roots[root_key])
    if loader == "trainval":
        kw["split_dir"] = roots["split_dir"]
    if loader == "predator":
        kw["num_pairs"] = 2
        return j_cls(**kw), t_cls(**kw)
    return j_cls(**kw), t_cls(**kw, device="cpu")


@pytest.mark.parametrize("loader,root_key,kwargs", CASES,
                         ids=[f"{c[0]}-{'-'.join(f'{k}={v}' for k, v in c[2].items())}"
                              for c in CASES])
def test_loader_matches_jax(roots, loader, root_key, kwargs):
    ref_ds, out_ds = make_pair(roots, loader, root_key, kwargs)
    assert len(out_ds) == len(ref_ds) > 0
    for i in range(len(ref_ds)):
        assert_samples_equal(out_ds[i], ref_ds[i], kwargs.get("in_dim", 6))
    if loader == "test":
        assert [out_ds.scene_of(i) for i in range(len(out_ds))] == \
            [ref_ds.scene_of(i) for i in range(len(ref_ds))]


def test_trainval_pairs_and_swap(roots):
    """The pair list of the split's list files, in the same order, and the
    seeded src/tgt swap: some pairs of 10 are swapped, some not."""
    kw = dict(root=roots["train"], split="train", split_dir=roots["split_dir"], num_node=64)
    ref, out = j_3dm.ThreeDMatchTrainVal(**kw), t_3dm.ThreeDMatchTrainVal(**kw, device="cpu")
    assert out.files == ref.files and len(out.files) == 10
    swaps = [np.random.default_rng((0, i)).random() > 0.5 for i in range(len(out))]
    assert any(swaps) and not all(swaps)


def test_trainval_packaged_splits():
    """The packaged split files are the JAX package's, byte for byte, and a
    loader without ``split_dir`` reads them."""
    j_dir = os.path.join(ROOT, "pointdsc_tpu", "data", "splits")
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_3dm.SPLIT_DIR)) and len(names) == 5
    for name in names:
        with open(os.path.join(j_dir, name), "rb") as a, \
                open(os.path.join(t_3dm.SPLIT_DIR, name), "rb") as b:
            assert a.read() == b.read(), name


def test_test_scene_filter_and_missing_gt(roots, tmp_path):
    """Only scenes with a gt.log are read (a second scene with fragments but
    no gt.log is skipped); a root without any raises FileNotFoundError in
    both packages."""
    root = str(tmp_path / "partial")
    shutil.copytree(roots["test"], root)
    other = "sun3d-hotel_uc-scan3"
    shutil.copytree(os.path.join(root, "fragments", SCENE), os.path.join(root, "fragments", other))
    ref = j_3dm.ThreeDMatchTest(root)
    out = t_3dm.ThreeDMatchTest(root, device="cpu")
    assert out.scene_list == ref.scene_list == [SCENE]
    assert out.keys == ref.keys
    for key in ref.gt_trans:
        np.testing.assert_array_equal(out.gt_trans[key], ref.gt_trans[key])
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for cls in (j_3dm.ThreeDMatchTest, t_3dm.ThreeDMatchTest):
        with pytest.raises(FileNotFoundError):
            cls(empty)


def test_load_gt_log(roots, tmp_path):
    """Every block of the fake root's gt.log and of one with tab- and
    space-separated rows of many digits, as the JAX parser reads them."""
    gt_path = os.path.join(roots["test"], "gt_result", f"{SCENE}-evaluation")
    for path in (gt_path, str(tmp_path)):
        if path == str(tmp_path):
            rng = np.random.default_rng(3)
            with open(os.path.join(path, "gt.log"), "w") as f:
                for i, j in ((0, 1), (0, 5), (12, 40)):
                    m = rng.normal(size=(4, 4))
                    f.write(f"{i}\t{j}\t41\n")
                    f.write("".join(" \t".join(repr(float(v)) for v in row) + "\n" for row in m))
        ref, out = j_3dm.load_gt_log(path), t_3dm.load_gt_log(path)
        assert list(out) == list(ref) and len(ref) >= 3
        for key in ref:
            assert out[key].dtype == np.float64
            np.testing.assert_array_equal(out[key], ref[key])


def test_concatenate_and_augment_pair():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 4, 4))
    np.testing.assert_array_equal(t_T.concatenate(a, b), j_T.concatenate(a, b))
    src = rng.normal(size=(50, 3)).astype(np.float32)
    tgt = rng.normal(size=(60, 3)).astype(np.float32)
    for axis, trans in ((3, np.eye(4, dtype=np.float32)), (1, rng.normal(size=(4, 4))),
                        (0, np.eye(4))):
        args = (src, tgt, trans, axis, 1.0, 0.5, 0.005)
        ref = j_T.augment_pair(*args, np.random.default_rng(7))
        gen = np.random.default_rng(7)
        out = t_T.augment_pair(*args, gen)
        for o, r in zip(out, ref):
            assert o.dtype == r.dtype == np.float64
            np.testing.assert_array_equal(o, r)
        # the same number of draws: the generators are in the same state after
        gen_ref = np.random.default_rng(7)
        j_T.augment_pair(*args, gen_ref)
        assert gen.random() == gen_ref.random()


def test_process_split(roots):
    kw = dict(root=roots["kitti"], split="test", num_node=300)
    ref = j_stats.process_split(j_kitti.KITTIDataset(**kw), bins=10)
    out = t_stats.process_split(t_kitti.KITTIDataset(**kw, device="cpu"), bins=10)
    for key in ("ratios", "hist", "edges"):
        np.testing.assert_array_equal(out[key], ref[key])
    assert (out["mean"], out["median"]) == (ref["mean"], ref["median"])
    part = t_stats.process_split(t_kitti.KITTIDataset(**kw, device="cpu"), num_samples=2)
    assert len(part["ratios"]) == 2 and part["hist"].sum() == 2


def test_print_split_report(roots, capsys):
    kw = dict(root=roots["kitti"], split="train", num_node=300)
    j_stats.print_split_report("train", j_stats.process_split(j_kitti.KITTIDataset(**kw)))
    ref = capsys.readouterr().out
    t_stats.print_split_report("train", t_stats.process_split(
        t_kitti.KITTIDataset(**kw, device="cpu")))
    assert capsys.readouterr().out == ref and ref.startswith("Split train: 2 pairs")


@pytest.mark.parametrize("spacing,n_poses,min_dist", [(8.0, 5, 10.0), (1.1, 40, 10.0),
                                                      (12.0, 4, 10.0), (0.5, 300, 5.0)])
def test_select_pairs(spacing, n_poses, min_dist):
    rng = np.random.default_rng(int(spacing * 10))
    poses = np.tile(np.eye(4), (n_poses, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.normal(spacing, 0.1 * spacing, (n_poses, 1))
                                * [1.0, 0.1, 0.0], axis=0)
    ids = list(range(n_poses - 1))
    out = t_prep.select_pairs(poses, ids, min_dist)
    assert out == j_prep.select_pairs(poses, ids, min_dist)
    assert all(isinstance(a, int) and isinstance(b, int) for a, b in out)


def test_odometry_poses_and_velodyne_gt(tmp_path):
    write_fake_drive(str(tmp_path), drive=8, n_frames=3, n_points=500, half_range=10.0)
    ref = j_prep.load_odometry_poses(str(tmp_path), 8)
    out = t_prep.load_odometry_poses(str(tmp_path), 8)
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (4, 4, 4)
    np.testing.assert_array_equal(t_prep.VELO2CAM, j_prep.VELO2CAM)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        gt = t_prep.velodyne_pair_gt(out[a], out[b])
        np.testing.assert_array_equal(gt, j_prep.velodyne_pair_gt(ref[a], ref[b]))
        # the fake drive moves the LiDAR 8 m along x a frame, without turning
        np.testing.assert_allclose(gt[:3, 3], [8.0 * (a - b), 0, 0], atol=1e-9)
        np.testing.assert_allclose(gt[:3, :3], np.eye(3), atol=1e-12)
    path = os.path.join(str(tmp_path), "sequences", "08", "velodyne", "000001.bin")
    np.testing.assert_array_equal(t_prep.read_velodyne_bin(path), j_prep.read_velodyne_bin(path))


def test_process_kitti_matches_jax(tmp_path):
    """Both packages' ``process_kitti`` on a 3-frame drive (one pair, 0-1),
    the port on the CPU: the same pair files, the ICP cache, and on a second
    run neither recomputes a written pair. The drive is a 10 m stretch of a
    6 m wide street without cars or poles, ~7k points a frame: sparser
    clouds, poles or cars leave keypoints with one or two neighbours in the
    normal radius, whose normal is any vector of a plane; the two packages
    pick different ones and FPFH spreads the difference over 1.5 m (at
    ~2k points a frame only 13-25% of the entries agree, with cars 94-98%).
    ICP runs on a 50 cm grid (``icp_voxel``), ~1k points, to keep the dense
    CPU searches short."""
    drive = str(tmp_path / "drive")
    write_fake_drive(drive, drive=8, n_frames=3, n_points=8000, spacing=6.0, half_range=5.0,
                     half_width=3.0, props=False)
    split_dir = str(tmp_path / "splits")  # the test split's drive 8 alone
    os.makedirs(split_dir)
    with open(os.path.join(split_dir, "test_kitti.txt"), "w") as f:
        f.write("8\n")
    outs = {}
    for name, fn, kw in (("jax", j_prep.process_kitti, {}),
                         ("torch", t_prep.process_kitti, {"device": "cpu"})):
        outs[name] = str(tmp_path / name)
        fn(drive, outs[name], split="test", split_dir=split_dir, icp_voxel=0.5, **kw)
    names = sorted(os.listdir(os.path.join(outs["jax"], "fpfh_test")))
    assert names == sorted(os.listdir(os.path.join(outs["torch"], "fpfh_test"))) \
        == ["pair_8_0_1.npz"]
    assert os.listdir(os.path.join(outs["torch"], "icp")) == ["8_0_1.npy"]
    ref = np.load(os.path.join(outs["jax"], "fpfh_test", names[0]))
    out = np.load(os.path.join(outs["torch"], "fpfh_test", names[0]))
    assert sorted(out.files) == sorted(ref.files)
    for key in ("xyz0", "xyz1"):
        np.testing.assert_array_equal(out[key], ref[key])
        assert len(out[key]) > 2000
    np.testing.assert_allclose(out["gt_trans"], ref["gt_trans"], atol=1e-4)
    # ICP starts at the odometry's transform (6 m along x without turning); the
    # street constrains x only by its facades' side walls, so ICP may slide a
    # little along it, but not across it or off level
    np.testing.assert_allclose(out["gt_trans"][:3, :3], np.eye(3), atol=1e-2)
    np.testing.assert_allclose(out["gt_trans"][1:3, 3], [0, 0], atol=0.05)
    assert abs(out["gt_trans"][0, 3] + 6.0) < 0.5
    for key, pts in (("features0", "xyz0"), ("features1", "xyz1")):
        _, valid = t_fpfh._chunked_radius_knn(torch.from_numpy(out[pts]), 100, 1.5)
        assert_fpfh_close(out[key], ref[key], valid.sum(1).float().numpy())

    # a second run leaves the written pair alone; a cached ICP result is reused
    stamp = os.path.getmtime(os.path.join(outs["torch"], "fpfh_test", names[0]))
    t_prep.process_kitti(drive, outs["torch"], split="test", split_dir=split_dir, icp_voxel=0.5,
                         device="cpu")
    assert os.path.getmtime(os.path.join(outs["torch"], "fpfh_test", names[0])) == stamp
    os.remove(os.path.join(outs["torch"], "fpfh_test", names[0]))
    cached = np.load(os.path.join(outs["torch"], "icp", "8_0_1.npy"))
    t_prep.process_kitti(drive, outs["torch"], split="test", split_dir=split_dir, icp_voxel=0.5,
                         device="cpu")
    again = np.load(os.path.join(outs["torch"], "fpfh_test", names[0]))
    np.testing.assert_array_equal(again["gt_trans"], cached)
    assert not [n for n in os.listdir(os.path.join(outs["torch"], "fpfh_test")) if ".tmp" in n]


def test_loaders_refuse_cuda_without_card(roots):
    """Without a card the in_dim=12 normals of a loader left at its default
    device raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ds = t_3dm.ThreeDMatchTest(roots["dense"], in_dim=12)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds[0]


def test_full_f32_matmul_across_threads():
    """The loader's threads enter ``full_f32_matmul`` (the in_dim=12 normals)
    while the main thread runs a forward in it: TF32 stays off while any
    thread is inside, and the caller's flags come back once all have left
    (saving and restoring per thread lost them). More threads than cores,
    a short switch interval, joins with a timeout."""
    from pointdsc_tpu_torch._device import full_f32_matmul

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, sys.getswitchinterval())
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    seen_on = []

    def work():
        for _ in range(200):
            with full_f32_matmul():
                seen_on.append(matmul.allow_tf32 or cudnn.allow_tf32)

    try:
        threads = [threading.Thread(target=work) for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(seen_on) == 200 * len(threads) and not any(seen_on)
        assert matmul.allow_tf32 and cudnn.allow_tf32
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved[:2]
        sys.setswitchinterval(saved[2])


def test_loader_threads_in_dim_12(roots):
    """The Loader's worker threads build in_dim=12 samples (normals in torch)
    concurrently: the batches equal those of one worker, bit for bit."""
    from pointdsc_tpu_torch.data.pipeline import Loader

    ds = t_3dm.ThreeDMatchTrainVal(roots["dense"], "train", split_dir=roots["split_dir"],
                                   num_node="all", in_dim=12, device="cpu")
    one = list(Loader(ds, 1, num_workers=1))
    many = list(Loader(ds, 1, num_workers=4))
    assert len(one) == len(many) == 2
    for a, b in zip(one, many):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
