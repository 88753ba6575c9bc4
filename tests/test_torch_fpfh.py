"""The port's registration front end against the JAX package on one small
seeded scan pair (``chip_smoke.make_scene`` in a 1 m room, a few thousand
keypoints): voxel downsampling, normals, FPFH, the whole extraction,
``build_correspondences`` (the ``in_dim=12`` normals included), the PLY
reader and writer, and the demo end to end."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import demo_registration as j_demo  # noqa: E402
from chip_smoke import make_scene  # noqa: E402
from pointdsc_tpu.data import pipeline as j_pipe  # noqa: E402
from pointdsc_tpu.data import ply as j_ply  # noqa: E402
from pointdsc_tpu.descriptors import fpfh as j_fpfh  # noqa: E402
from pointdsc_tpu_torch.data import pipeline as t_pipe  # noqa: E402
from pointdsc_tpu_torch.data import ply as t_ply  # noqa: E402
from pointdsc_tpu_torch.descriptors import fpfh as t_fpfh  # noqa: E402
from pointdsc_tpu_torch.tools import demo_registration as t_demo  # noqa: E402

VOXEL = 0.03


@pytest.fixture(scope="module")
def scene():
    """(src raw [P, 3], tgt raw, gt, src keypoints): ~2-3k keypoints per
    cloud at the 3 cm voxel, dense enough that every normal neighbourhood
    holds a surface patch."""
    src, tgt, gt = make_scene(0, n_points=6000, room=1.0, overlap_cut=(0.8, 0.24))
    return src, tgt, gt, j_fpfh.voxel_downsample(src, VOXEL)


def assert_fpfh_close(out, ref, count):
    """At least 99.5% of the entries within 1e-3; each other one off by at
    most one neighbour's share of a histogram in SPFH and in the aggregate
    (2 x 100 / the point's valid neighbour count): an angle on a bin edge may
    fall on either side of it in the two packages. Measured: every entry
    within 4e-4."""
    diff = np.abs(out - ref)
    assert (diff <= 1e-3).mean() >= 0.995
    assert (diff <= 2.0 * 100.0 / np.maximum(count, 1.0)[:, None] + 1e-3).all()


def test_voxel_downsample(scene):
    src = scene[0]
    out = t_fpfh.voxel_downsample(src, VOXEL)
    np.testing.assert_array_equal(out, scene[3])
    assert out.dtype == np.float32 and 1000 < len(out) < len(src)


def test_estimate_normals(scene):
    """atol 1e-4 (measured 3e-6): the same Jacobi sweeps on covariances whose
    sums run in another order; the orientation rule gives the same sign."""
    pts = scene[3]
    ref = np.asarray(j_fpfh.estimate_normals(jnp.asarray(pts), 2 * VOXEL, max_nn=30))
    out = t_fpfh.estimate_normals(torch.from_numpy(pts), 2 * VOXEL, max_nn=30).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_fpfh_features(scene):
    """On JAX's own normals, so only the histograms differ."""
    pts = scene[3]
    normals = np.array(j_fpfh.estimate_normals(jnp.asarray(pts), 2 * VOXEL, max_nn=30))
    ref = np.asarray(j_fpfh.fpfh_features(jnp.asarray(pts), jnp.asarray(normals), 5 * VOXEL,
                                          max_nn=100))
    out = t_fpfh.fpfh_features(torch.from_numpy(pts), torch.from_numpy(normals), 5 * VOXEL,
                               max_nn=100).numpy()
    _, valid = t_fpfh._chunked_radius_knn(torch.from_numpy(pts), 100, 5 * VOXEL)
    assert out.shape == ref.shape == (len(pts), 33)
    assert_fpfh_close(out, ref, valid.sum(1).float().numpy())


def test_radius_knn_ties_go_to_the_lower_index():
    """Equidistant neighbours (a grid) come in index order, as lax.top_k
    gives them; self is never a neighbour."""
    g = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    g = g.astype(np.float32) * np.float32(0.25)
    idx, valid = t_fpfh._chunked_radius_knn(torch.from_numpy(g), 8, 0.3, chunk=32)
    jidx, jvalid = j_fpfh._chunked_radius_knn(jnp.asarray(g), 8, 0.3, chunk=32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not (idx.numpy() == np.arange(len(g))[:, None]).any()


@pytest.mark.parametrize("k,radius", [(30, 2 * VOXEL), (100, 5 * VOXEL)])
def test_radius_knn_equals_jax(scene, k, radius):
    """The written-out gram form rounds d2 as the JAX package's matrix
    product does on the CPU: the same neighbourhoods, exactly (a few
    neighbours of near-equal distance come in the other order)."""
    pts = scene[3]
    idx, valid = t_fpfh._chunked_radius_knn(torch.from_numpy(pts), k, radius)
    jidx, jvalid = j_fpfh._chunked_radius_knn(jnp.asarray(pts), k, radius)
    np.testing.assert_array_equal(np.sort(np.where(valid.numpy(), idx.numpy(), -1), axis=1),
                                  np.sort(np.where(jvalid, jidx, -1), axis=1))


def test_extract_fpfh(scene):
    src = scene[0]
    jk, jf = j_fpfh.extract_fpfh(src, voxel_size=VOXEL)
    tk, tf = t_fpfh.extract_fpfh(src, voxel_size=VOXEL, device="cpu")
    np.testing.assert_array_equal(tk, jk)
    _, valid = t_fpfh._chunked_radius_knn(torch.from_numpy(tk), 100, 5 * VOXEL)
    assert_fpfh_close(tf, jf, valid.sum(1).float().numpy())


@pytest.mark.parametrize("in_dim,use_mutual,num_node", [(6, False, 512), (6, True, "all"),
                                                        (9, False, 300), (12, False, 400)])
def test_build_correspondences(scene, in_dim, use_mutual, num_node):
    """The same rng.choice calls: the same keypoints and correspondences from
    one seed; every array equal. The in_dim=12 normals within 1e-4 where the
    sampled keypoint has at least 3 neighbours within the normal radius; with
    exactly 2 the covariance has rank 1 and the normal is any unit vector
    across the pair's line (measured: every mismatch is such a point)."""
    src, tgt, gt, _ = scene
    (sk, sf), (tk, tf) = (j_fpfh.extract_fpfh(c, voxel_size=VOXEL) for c in (src, tgt))
    sf = sf / (np.linalg.norm(sf, axis=1, keepdims=True) + 1e-6)
    tf = tf / (np.linalg.norm(tf, axis=1, keepdims=True) + 1e-6)
    args = (sk, tk, sf, tf, gt, 0.1)
    kw = dict(num_node=num_node, use_mutual=use_mutual, in_dim=in_dim)
    ref = j_pipe.build_correspondences(*args, rng=np.random.default_rng(51), **kw)
    out = t_pipe.build_correspondences(*args, rng=np.random.default_rng(51), device="cpu", **kw)
    assert out.keys() == ref.keys()
    for key in ref:
        assert out[key].dtype == ref[key].dtype and out[key].shape == ref[key].shape
        if key != "corr_pos" or in_dim != 12:
            np.testing.assert_array_equal(out[key], ref[key])
    if in_dim == 12:
        rs = np.random.default_rng(51)
        clouds = (sk[rs.choice(len(sk), num_node, replace=False)],
                  tk[rs.choice(len(tk), num_node, replace=False)])
        for c, pts, cloud in ((3, out["src_keypts"], clouds[0]), (9, out["tgt_keypts"], clouds[1])):
            np.testing.assert_array_equal(out["corr_pos"][:, c - 3:c], ref["corr_pos"][:, c - 3:c])
            got, want = out["corr_pos"][:, c:c + 3], ref["corr_pos"][:, c:c + 3]
            neighbours = (np.linalg.norm(pts[:, None] - cloud[None], axis=-1) < 0.06).sum(1) - 1
            well = neighbours >= 3
            assert well.sum() > 50
            np.testing.assert_allclose(got[well], want[well], atol=1e-4)
            np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert out["gt_labels"].mean() > 0.05  # the gt registers some of them


@pytest.mark.parametrize("fmt", ["binary", "ascii"])
def test_ply_round_trip(tmp_path, rng, fmt):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    path = str(tmp_path / "c.ply")
    if fmt == "binary":
        t_ply.write_ply_xyz(path, pts)
    else:
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex 100\nproperty float x\n"
                    "property float y\nproperty float z\nproperty uchar red\nend_header\n")
            for p in pts:
                f.write(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g} 7\n")
    out, ref = t_ply.read_ply_xyz(path), j_ply.read_ply_xyz(path)
    assert out.dtype == np.float64 and out.shape == (100, 3)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out.astype(np.float32), pts)


def test_demo_matches_jax(scene, tmp_path, monkeypatch):
    """The port's demo (fused forward behind the regime probe, plain
    versions on the CPU) against the JAX demo (dense forward) on one seeded
    PLY pair with the Synthetic snapshot, --num_node 256, ICP on: the final
    transforms within 1e-3 (measured 6e-5); both register the pair; the
    three output files are written."""
    src, tgt, gt, _ = scene
    t_ply.write_ply_xyz(str(tmp_path / "s.ply"), src)
    t_ply.write_ply_xyz(str(tmp_path / "t.ply"), tgt)
    monkeypatch.chdir(ROOT)  # both demos read snapshot/<name> from the working directory
    args = ["--src_path", str(tmp_path / "s.ply"), "--tgt_path", str(tmp_path / "t.ply"),
            "--chosen_snapshot", "PointDSC_Synthetic_release", "--num_node", "256",
            "--use_icp", "true"]
    ref = j_demo.main(args + ["--out_dir", str(tmp_path / "j")])
    report = {}
    with torch.no_grad():
        out = t_demo.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"],
                          report=report)
    np.testing.assert_allclose(out, ref, atol=1e-3)
    r = out[:3, :3] @ gt[:3, :3].T
    assert np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))) < 5.0
    assert np.linalg.norm(out[:3, 3] - gt[:3, 3]) < 0.1
    assert set(report["stages_s"]) == {"load", "fpfh", "matching", "model", "forward", "icp"}
    for name in ("src_warped.ply", "tgt.ply", "pred_trans.npy"):
        assert os.path.exists(tmp_path / "t" / name)
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "pred_trans.npy"), out)
