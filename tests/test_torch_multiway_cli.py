"""The port's three multiway CLIs (``pointdsc_tpu_torch/multiway/``) through
``main(argv)`` with ``--device cpu`` against the JAX package's on the same
roots, each package in a working directory of its own (the CLIs read
``snapshot/<id>/`` from it and write ``logs/`` into it); the JAX side with
64-bit types off (its accelerator's mode).

* ``test_multi_ate --use_icp true --save_traj true`` on a fake Redwood root
  (``write_fake_redwood``: 3 fragments of 500 points) with a 2-layer, C = 32
  snapshot written by the port's Trainer: the ATE within 1e-3 cm, the kept
  edges' count, and the saved trajectories within 1e-5 (float32 poses
  through 30 + 30 Gauss-Newton steps and 4-5 multi-scale ICP runs);
* ``test_multi`` on the same root: the 12-column stats equal JAX's in every
  column but the two times (success flags, inlier counts, ratios, scene
  exactly; TE within 1e-3 cm, RE as cos(RE) within 1e-6, the rule of
  tests/test_torch_cli.py);
* the regime guard's flip on a 3-layer snapshot with key projections scaled
  by 100 (the JAX tests' ``_inflate_keys``), ``--fused true``: the port
  prints its own message and runs the running-max kernels' plain versions;
* ``make_fragments`` on a 4-frame 80 x 60 RGB-D scene written by PIL (16-bit
  depth, RGB), 2 frames a fragment, the TSDF cut to a 64 x 64 x 48 grid of
  3 cm in both packages: the ``.npy`` poses exactly, the PLY points and the
  FPFH keypoints by the share within 1e-5 of JAX's (>= 0.95: a voxel near a
  pixel's edge rounds to the neighbouring pixel in one package, see
  tests/test_torch_fusion.py), the features' shape.
"""

import functools
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from pointdsc_tpu.eval import runner as j_runner  # noqa: E402
from pointdsc_tpu.fusion import fragments as j_frag  # noqa: E402
from pointdsc_tpu_torch.data.ply import read_ply_xyz  # noqa: E402
from pointdsc_tpu_torch.eval.redwood_protocol import read_trajectory  # noqa: E402
from pointdsc_tpu_torch.fusion import fragments as t_frag  # noqa: E402
from pointdsc_tpu_torch.multiway import make_fragments as t_make  # noqa: E402
from pointdsc_tpu_torch.multiway import test_multi as t_multi  # noqa: E402
from pointdsc_tpu_torch.multiway import test_multi_ate as t_ate  # noqa: E402
from test_multiway_cli_integration import SCENE, write_fake_redwood  # noqa: E402
from test_torch_cli import write_snapshot  # noqa: E402
from test_torch_fusion import J_INTR, frames  # noqa: E402

TIME_COLUMNS = (9, 10)


def x32():
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def redwood(tmp_path_factory):
    base = tmp_path_factory.mktemp("multiway")
    root = str(base / "redwood")
    write_fake_redwood(root, np.random.default_rng(51), num_frag=3, n_pts=500)
    dirs = {}
    for pkg in ("port", "jax"):
        dirs[pkg] = str(base / pkg)
        write_snapshot(dirs[pkg], "small", "3DMatch", root)
    return {"root": root, **dirs}


def run_in(wd, monkeypatch, fn, *args):
    monkeypatch.chdir(wd)
    return fn(*args)


def test_multi_ate_matches_jax(redwood, monkeypatch, capsys):
    from multiway.test_multi_ate import main as jax_main

    argv = ["--root", redwood["root"], "--scenes", SCENE, "--num_node", "256",
            "--chosen_snapshot", "small", "--use_icp", "true", "--save_traj", "true"]
    ates = run_in(redwood["port"], monkeypatch, t_ate.main, argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    with x32():
        want = run_in(redwood["jax"], monkeypatch, jax_main, argv)
    jax_out = capsys.readouterr().out
    assert len(ates) == 1 and np.isfinite(ates[0])
    np.testing.assert_allclose(ates, want, atol=1e-3)
    kept = [re.search(r"\((\d+) edges kept\)", out).group(1) for out in (port_out, jax_out)]
    assert kept[0] == kept[1] and int(kept[0]) >= 2
    name = os.path.join("logs", f"{SCENE}_traj.log")
    keys_t, traj_t = read_trajectory(os.path.join(redwood["port"], name))
    keys_j, traj_j = read_trajectory(os.path.join(redwood["jax"], name))
    np.testing.assert_array_equal(keys_t, keys_j)
    assert traj_t.shape == (3, 4, 4)
    np.testing.assert_allclose(traj_t, traj_j, atol=1e-5)


def test_multi_matches_jax(redwood, monkeypatch):
    from multiway.test_multi import main as jax_main

    recorded = []
    run_dataset = j_runner.Evaluator.run_dataset

    def record(self, *args, **kwargs):
        stats, agg = run_dataset(self, *args, **kwargs)
        recorded.append(stats)
        return stats, agg

    monkeypatch.setattr(j_runner.Evaluator, "run_dataset", record)
    argv = ["--root", redwood["root"], "--scenes", SCENE, "--num_node", "256",
            "--chosen_snapshot", "small"]
    stats, agg = run_in(redwood["port"], monkeypatch, t_multi.main, argv + ["--device", "cpu"])
    with x32():
        run_in(redwood["jax"], monkeypatch, jax_main, argv)
    (want,) = recorded
    assert stats.shape == want.shape == (3, 12)
    exact = [c for c in range(12) if c not in TIME_COLUMNS + (1, 2)]
    np.testing.assert_array_equal(stats[:, exact], want[:, exact])
    np.testing.assert_allclose(stats[:, 2], want[:, 2], atol=1e-3)  # TE, cm
    # RE as cos(RE): near 0 arccos turns a 1e-7 rounding of the trace into ~0.05 deg
    np.testing.assert_allclose(np.cos(np.deg2rad(stats[:, 1])), np.cos(np.deg2rad(want[:, 1])),
                               atol=1e-6)
    assert 0.0 <= agg["pair_recall"] <= 100.0


def test_multi_ate_guard_flips_for_inflated_keys(tmp_path, monkeypatch, capsys):
    """The JAX CLI's regime test, on the port: a snapshot whose key
    projections are scaled by 100 leaves the offset softmax's regime, and
    ``--fused true`` switches the model to the running-max kernel."""
    import jax.numpy as jnp
    from flax import serialization

    from pointdsc_tpu.models.pointdsc import PointDSC as JaxPointDSC
    from pointdsc_tpu.train.config import default_config
    from test_offset_regime import _inflate_keys

    root = str(tmp_path / "redwood")
    write_fake_redwood(root, np.random.default_rng(51), num_frag=3, n_pts=300)
    cfg = default_config("3DMatch")
    cfg.num_layers = 3
    snap = tmp_path / "snapshot" / "badsnap"
    (snap / "models").mkdir(parents=True)
    cfg.save(str(snap / "config.json"))
    model = JaxPointDSC(in_dim=cfg.in_dim, num_layers=cfg.num_layers,
                        num_channels=cfg.num_channels, num_iterations=cfg.num_iterations,
                        ratio=cfg.ratio, sigma_d=cfg.sigma_d, k=cfg.k,
                        inlier_threshold=cfg.inlier_threshold, nms_radius=cfg.inlier_threshold)
    with x32():
        dummy = jnp.zeros((1, 256, 3), jnp.float32)
        variables = model.init(jax.random.key(0), jnp.zeros((1, 256, 6), jnp.float32), dummy,
                               dummy)
        bad = _inflate_keys(variables, 100.0)
    with open(snap / "models" / "model_best.pkl", "wb") as f:
        f.write(serialization.to_bytes({"params": bad["params"],
                                        "batch_stats": bad["batch_stats"]}))
    ates = run_in(str(tmp_path), monkeypatch, t_ate.main,
                  ["--root", root, "--scenes", SCENE, "--num_node", "256", "--chosen_snapshot",
                   "badsnap", "--fused", "true", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[multiway] offset-softmax bound slack" in out, out
    assert "selecting the running-max attention kernel instead" in out, out
    assert len(ates) == 1 and np.isfinite(ates[0])


def write_rgbd_scene(scene_dir, n_frames=4):
    """``frames`` of tests/test_torch_fusion.py as the reference stores a
    sequence: 16-bit millimeter depth PNGs and RGB PNGs, written by PIL."""
    poses, depths, colors = frames(n_frames, step=(0.02, 0.0, 0.0), deg=0.004)
    os.makedirs(os.path.join(scene_dir, "depth"))
    os.makedirs(os.path.join(scene_dir, "image"))
    for i, (d, c) in enumerate(zip(depths, colors)):
        Image.fromarray(np.clip(d * 1000.0, 0, 65535).astype(np.uint16)).save(
            os.path.join(scene_dir, "depth", f"{i:06d}.png"))
        rgb = np.clip(np.stack([c, 0.8 * c, 1.0 - c], -1) * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(scene_dir, "image", f"{i:06d}.png"))
    return poses


def near_share(a, b, tol=1e-5):
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1).min(1)
    return float((d2 <= tol * tol).mean())


def test_make_fragments_matches_jax(tmp_path, monkeypatch):
    from multiway.make_fragments import main as jax_main

    scene = str(tmp_path / "scene")
    write_rgbd_scene(scene)
    intr = str(tmp_path / "intr.json")
    with open(intr, "w") as f:
        json.dump({"width": J_INTR.width, "height": J_INTR.height, "fx": J_INTR.fx,
                   "fy": J_INTR.fy, "cx": J_INTR.cx, "cy": J_INTR.cy}, f)
    for mod in (t_frag, j_frag):  # the TSDF grid cut to size in both packages
        monkeypatch.setattr(mod, "build_fragment",
                            functools.partial(mod.build_fragment, grid_dims=(64, 64, 48)))
    argv = ["--path_dataset", scene, "--n_frames_per_fragment", "2", "--voxel_size", "0.03",
            "--fpfh_voxel", "0.05", "--path_intrinsic", intr]
    out_t = t_make.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    with x32():
        out_j = jax_main(argv + ["--out_dir", str(tmp_path / "jax")])
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == sorted(
        f"fragment_{f:03d}{ext}" for f in range(2) for ext in (".ply", ".npy", "_fpfh.npz"))
    for f in range(2):
        name = os.path.join("{}", f"fragment_{f:03d}")
        np.testing.assert_allclose(np.load(name.format(out_t) + ".npy"),
                                   np.load(name.format(out_j) + ".npy"), atol=1e-5)
        pts_t = read_ply_xyz(name.format(out_t) + ".ply")
        pts_j = read_ply_xyz(name.format(out_j) + ".ply")
        assert len(pts_t) > 300 and abs(len(pts_t) - len(pts_j)) <= 0.02 * len(pts_j)
        assert near_share(pts_t, pts_j) >= 0.95
        npz_t = np.load(name.format(out_t) + "_fpfh.npz")
        npz_j = np.load(name.format(out_j) + "_fpfh.npz")
        assert npz_t["feature"].shape == (len(npz_t["xyz"]), 33)
        assert abs(len(npz_t["xyz"]) - len(npz_j["xyz"])) <= 0.05 * len(npz_j["xyz"])
        assert near_share(npz_t["xyz"], npz_j["xyz"]) >= 0.9
