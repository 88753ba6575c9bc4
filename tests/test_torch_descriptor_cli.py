"""The port's descriptor preparation CLIs (``pointdsc_tpu_torch/tools/
cal_fpfh.py``, ``cal_fcgf.py``) and the scene and pair functions of
``tools/train_fcgf.py`` against the JAX package's tools on the CPU.

* ``cal_fpfh.run_job`` for the three jobs on a fake root (two training
  ``.npz`` clouds, two test-scene PLYs, one Redwood PLY; two perpendicular
  planes of 4000 points each): the same files with the same keys as JAX's, ``points`` and
  ``xyz`` bit for bit, ``feature`` as ``tests/test_torch_fpfh.py`` holds
  FPFH (>= 99.5% of the entries within 1e-3), read back by the port's
  ``data/threedmatch.py::_load_fragment``;
* ``cal_fcgf.run_job`` with a tiny VoxelFCGF whose weights are a checkpoint
  file that JAX's ``flax.serialization.to_bytes`` wrote from its init, read
  by the port's reader: the same files, ``xyz`` bit for bit, ``feature``
  within 1e-4 (float32 forwards in two frameworks);
* ``cal_fcgf.main`` with the release checkpoint at a 32^3 grid: the count
  and the files ``_load_fragment`` reads;
* ``make_scene``, ``random_pose``, ``make_pair`` and ``inlier_ratio`` from
  one ``np.random.default_rng`` state: every array equal to JAX's.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tools.cal_fcgf as j_cal_fcgf  # noqa: E402
import tools.cal_fpfh as j_cal_fpfh  # noqa: E402
import tools.train_fcgf as j_train_fcgf  # noqa: E402
from pointdsc_tpu.descriptors.fcgf import VoxelFCGF as JaxVoxelFCGF  # noqa: E402
from pointdsc_tpu_torch.compat.fcgf_weights import load_fcgf_state_dict  # noqa: E402
from pointdsc_tpu_torch.data.ply import write_ply_xyz  # noqa: E402
from pointdsc_tpu_torch.data.threedmatch import TEST_SCENES, _load_fragment  # noqa: E402
from pointdsc_tpu_torch.descriptors.fcgf import VoxelFCGF  # noqa: E402
from pointdsc_tpu_torch.tools import cal_fcgf, cal_fpfh, train_fcgf  # noqa: E402

TINY = dict(out_dim=16, enc_channels=(8, 16, 32, 32), dec_channels=(16, 16, 8, 8))
SCENE, REDWOOD = TEST_SCENES[0], "livingroom1-simulated"
RELEASE = os.path.join(ROOT, "snapshot", "fcgf_synth_release.pkl")


def make_cloud(gen, n=4000):
    """Two perpendicular 1 m planes off the origin, 2 mm noise: FPFH gets real
    geometry, and every normal a neighbourhood of tens of points (at 600
    points a few normals come from 1-2 neighbours, are ill-defined, and
    differ between any two implementations)."""
    a = np.stack([gen.uniform(0, 1, n // 2), gen.uniform(0, 1, n // 2), np.zeros(n // 2)], -1)
    b = np.stack([np.zeros(n - n // 2), gen.uniform(0, 1, n - n // 2),
                  gen.uniform(0, 1, n - n // 2)], -1)
    return np.concatenate([a, b]) + gen.normal(size=(n, 3)) * 0.002 + np.array([0.3, 0.2, 0.4])


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("desc") / "root"
    gen = np.random.default_rng(11)
    (root / "threedmatch").mkdir(parents=True)
    for name in ("sceneA_000.npz", "sceneA_001.npz"):
        np.savez(root / "threedmatch" / name, pcd=make_cloud(gen))
    np.savez(root / "threedmatch" / "other.npz", xyz=make_cloud(gen))  # no 'pcd': skipped
    for sub in (root / "fragments" / SCENE, root / REDWOOD / "fragments"):
        sub.mkdir(parents=True)
    for i in range(2):
        write_ply_xyz(str(root / "fragments" / SCENE / f"cloud_bin_{i}.ply"), make_cloud(gen))
    write_ply_xyz(str(root / REDWOOD / "fragments" / "fragment_000.ply"), make_cloud(gen))
    return root


JOBS = [("3dmatch", None, "threedmatch_feat/sceneA_00{}"),
        ("3dmatch_test", [SCENE], f"fragments/{SCENE}/cloud_bin_{{}}"),
        ("redwood", [REDWOOD], f"{REDWOOD}/fragments/fragment_00{{}}")]


def copies(fake_root, tmp_path):
    port, ref = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(fake_root, port)
    shutil.copytree(fake_root, ref)
    return port, ref


def written(root, suffix):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(suffix))


@pytest.mark.parametrize("job,scenes,stem", JOBS)
def test_cal_fpfh(fake_root, tmp_path, job, scenes, stem):
    port, ref = copies(fake_root, tmp_path)
    n = cal_fpfh.run_job(job, str(port), 0.05, scenes, verbose=False, device="cpu")
    j_run = {"3dmatch": lambda: j_cal_fpfh.process_3dmatch(str(ref), 0.05, verbose=False),
             "3dmatch_test": lambda: j_cal_fpfh.process_3dmatch_test(str(ref), 0.05, scenes,
                                                                      verbose=False),
             "redwood": lambda: j_cal_fpfh.process_redwood(str(ref), 0.05, scenes,
                                                           verbose=False)}[job]
    assert n == j_run() == (1 if job == "redwood" else 2)
    assert written(port, "_fpfh.npz") == written(ref, "_fpfh.npz") != []
    for rel in written(ref, "_fpfh.npz"):
        a, b = np.load(port / rel), np.load(ref / rel)
        assert sorted(a.files) == sorted(b.files) == ["feature", "points", "xyz"]
        np.testing.assert_array_equal(a["points"], b["points"])
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        assert a["feature"].dtype == np.float32 and a["feature"].shape[1] == 33
        assert (np.abs(a["feature"] - b["feature"]) <= 1e-3).mean() >= 0.995
    xyz, feat = _load_fragment(str(port / stem.format(0)), "fpfh")
    assert feat.shape == (len(xyz), 33)
    np.testing.assert_allclose(np.linalg.norm(feat, axis=1), 1.0, atol=1e-3)


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """(JAX model, its init, the checkpoint file JAX wrote from it)."""
    model = JaxVoxelFCGF(**TINY)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 32, 1)))
    path = tmp_path_factory.mktemp("ckpt") / "fcgf_tiny.pkl"
    path.write_bytes(serialization.to_bytes(variables))
    return model, variables, str(path)


@pytest.mark.parametrize("job,scenes,stem", JOBS)
def test_cal_fcgf(fake_root, tmp_path, tiny_checkpoint, job, scenes, stem):
    model, variables, path = tiny_checkpoint
    port, ref = copies(fake_root, tmp_path)
    net = VoxelFCGF(**TINY, device="cpu")
    net.load_state_dict(load_fcgf_state_dict(path))
    n = cal_fcgf.run_job(job, str(port), net, 0.05, 32, False, scenes, verbose=False)
    assert n == j_cal_fcgf.run_job(job, str(ref), model, variables, 0.05, 32, False, scenes,
                                   verbose=False)
    assert written(port, "_fcgf.npz") == written(ref, "_fcgf.npz") != []
    for rel in written(ref, "_fcgf.npz"):
        a, b = np.load(port / rel), np.load(ref / rel)
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_array_equal(a["points"], b["points"])
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        np.testing.assert_allclose(a["feature"], b["feature"], atol=1e-4)
    xyz, feat = _load_fragment(str(port / stem.format(0)), "fcgf")
    assert feat.shape == (len(xyz), 16) and np.isfinite(feat).all()


def test_cal_fcgf_main_release(fake_root, tmp_path, capsys):
    port = tmp_path / "port"
    shutil.copytree(fake_root, port)
    n = cal_fcgf.main(["--job", "3dmatch_test", "--root", str(port), "--scenes", SCENE,
                       "--checkpoint", RELEASE, "--grid_size", "32", "--device", "cpu"])
    assert n == 2
    assert f"loaded VoxelFCGF weights from {RELEASE}" in capsys.readouterr().out
    for i in range(2):
        xyz, feat = _load_fragment(str(port / "fragments" / SCENE / f"cloud_bin_{i}"), "fcgf")
        assert feat.shape == (len(xyz), 32) and len(xyz) > 100
        np.testing.assert_allclose(np.linalg.norm(feat, axis=1), 1.0, atol=1e-4)


def test_scene_and_pair_functions():
    """One generator state through both packages' functions, in the order
    ``train_fcgf.main`` calls them: every array equal."""
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    np.testing.assert_array_equal(train_fcgf.make_scene(a), j_train_fcgf.make_scene(b))
    np.testing.assert_array_equal(train_fcgf.random_pose(a), j_train_fcgf.random_pose(b))
    got, ref = train_fcgf.make_pair(a, 0.05, 64), j_train_fcgf.make_pair(b, 0.05, 64)
    np.testing.assert_array_equal(got[0][0], ref[0][..., 0])
    np.testing.assert_array_equal(got[1][0], ref[1][..., 0])
    for x, y in zip(got[2:5] + got[5], ref[2:5] + ref[5]):
        np.testing.assert_array_equal(x, y)
    assert got[4].dtype == bool and 0 < got[4].sum()
    view0, view1, pose = got[5]
    kp = view0[::50]
    feats = np.random.default_rng(0).normal(size=(len(kp), 8))
    noisy = feats + 0.5 * np.random.default_rng(1).normal(size=feats.shape)
    ir = train_fcgf.inlier_ratio(kp, feats, view1[::50], noisy, pose)
    assert ir == j_train_fcgf.inlier_ratio(kp, feats, view1[::50], noisy, pose)
    assert 0.0 < ir < 1.0
