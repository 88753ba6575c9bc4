"""Multiway registration in the port against the JAX package, on the CPU:
the Lie maps, the pose graph, the ATE, multi-scale ICP, the pose-graph
assembly and its second pass, the Redwood loader and the Redwood protocol.

The JAX side runs with 64-bit types off (its accelerator's mode):
``tests/conftest.py`` turns them on, and then ``optimize_pose_graph``'s
anchor prior, made without a dtype, is float64 and turns every pose after
the first step into float64, while the port computes in float32.

Tolerances: the Lie maps within 3e-6 (a few float32 steps of an angle up to
pi; near pi the axis comes from sqrt of the diagonal, where one step of the
trace moves the log by ~1e-6); the pose graph's poses within 1e-5 (30
Gauss-Newton steps of two float32 implementations, which agree to ~4e-7 on
these graphs); multi-scale ICP's transform within 1e-5 and its information
matrix within 1e-5 relative (a sum over ~100-800 matches); the ATE within
1e-4 cm. Kept edges, the loader's samples and the protocol's outputs are
held exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from pointdsc_tpu.data import transforms_np as T  # noqa: E402
from pointdsc_tpu.data.redwood import RedwoodDataset as JaxRedwood  # noqa: E402
from pointdsc_tpu.eval import redwood_protocol as jproto  # noqa: E402
from pointdsc_tpu.multiway import ate as jate  # noqa: E402
from pointdsc_tpu.multiway import pose_graph as jpg  # noqa: E402
from pointdsc_tpu.multiway import registration as jreg  # noqa: E402
from pointdsc_tpu.ops import lie as jlie  # noqa: E402
from pointdsc_tpu_torch.data.redwood import RedwoodDataset  # noqa: E402
from pointdsc_tpu_torch.eval import redwood_protocol as tproto  # noqa: E402
from pointdsc_tpu_torch.multiway import ate as tate  # noqa: E402
from pointdsc_tpu_torch.multiway import pose_graph as tpg  # noqa: E402
from pointdsc_tpu_torch.multiway import registration as treg  # noqa: E402
from pointdsc_tpu_torch.ops import lie as tlie  # noqa: E402
import test_lie_icp_posegraph as jax_lie_tests  # noqa: E402
from test_multiway_cli_integration import SCENE, write_fake_redwood  # noqa: E402


def x32():
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def twists(rng, n=64):
    """Rotation vectors at the Taylor branches' edges (0, 1e-9, 1e-6, 1e-4,
    1e-3), near pi (3.1, 3.13, pi - 1e-4, pi) and at random angles, with
    random translations: [n, 6] float32."""
    angles = np.concatenate([[0.0, 1e-9, 1e-6, 1e-4, 1e-3, 3.1, 3.13, np.pi - 1e-4, np.pi],
                             rng.uniform(0.0, 3.1, n - 9)])
    axis = rng.normal(size=(n, 3))
    w = axis / np.linalg.norm(axis, axis=1, keepdims=True) * angles[:, None]
    return np.concatenate([w, rng.normal(size=(n, 3))], axis=1).astype(np.float32)


@pytest.mark.parametrize("fn", ["so3_exp", "so3_log", "se3_exp", "se3_log", "skew", "V"])
def test_lie_maps_match_jax(rng, fn):
    xi = twists(rng)
    with x32():
        R = np.asarray(jlie.so3_exp(jnp.asarray(xi[:, :3])))
        Tm = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    arg = {"so3_exp": xi[:, :3], "so3_log": R, "se3_exp": xi, "se3_log": Tm,
           "skew": xi[:, :3], "V": xi[:, :3]}[fn]
    name = "_V_matrix" if fn == "V" else fn
    with x32():
        want = np.asarray(getattr(jlie, name)(jnp.asarray(arg)))
    got = getattr(tlie, name)(torch.from_numpy(np.array(arg))).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=3e-6, rtol=0)


def test_lie_round_trips_and_branches(rng):
    """exp(log(R)) = R within 2e-5 and log(exp(xi)) = xi within 2e-4 below
    3 rad (the
    log divides the skew part by sin(theta), ~0.14 at 3 rad; nearer pi the
    axis comes from the diagonal's square roots, good to ~4e-4 in float32,
    in both packages alike: the parity test above holds it there), and the
    small-angle branch returns the identity."""
    xi = torch.from_numpy(twists(rng))
    below = torch.linalg.norm(xi[:, :3], dim=-1) < 3.0
    R = tlie.so3_exp(xi[below, :3])
    np.testing.assert_allclose(tlie.so3_exp(tlie.so3_log(R)).numpy(), R.numpy(), atol=2e-5)
    # the translation through V^-1, whose conditioning falls towards pi
    np.testing.assert_allclose(tlie.se3_log(tlie.se3_exp(xi))[below].numpy(),
                               xi[below].numpy(), atol=2e-4)
    np.testing.assert_allclose(tlie.so3_exp(torch.tensor([[1e-9, 0.0, 0.0]]))[0].numpy(),
                               np.eye(3), atol=1e-7)


def test_edge_jacobians_finite_at_identity_edges():
    """The Gauss-Newton Jacobians of zero-residual (identity) edges are
    finite (the untaken Taylor branches get a zero gradient, not 0 * inf)
    and equal central differences of the same residual in float64 within
    1e-4 (the clamp of the log's cosine at 1 - 1e-7 moves the float32
    Jacobian by ~1e-7 there)."""
    E = 3
    eye = np.tile(np.eye(4), (E, 1, 1))
    eye[2, :3, 3] = [0.3, -0.1, 0.2]  # a pure translation, rotation residual 0
    Ti = torch.from_numpy(eye).float()
    mi = torch.eye(4).repeat(E, 1, 1)
    zeros = torch.zeros((E, 6))
    Ji, Jj = tpg._edge_jacobians(zeros, zeros, Ti, Ti, mi)
    assert torch.isfinite(Ji).all() and torch.isfinite(Jj).all()
    h = 1e-6
    for J, which in ((Ji, 0), (Jj, 1)):
        for k in range(6):
            step = torch.zeros((E, 6), dtype=torch.float64)
            step[:, k] = h
            args = [torch.zeros((E, 6), dtype=torch.float64)] * 2
            plus, minus = list(args), list(args)
            plus[which], minus[which] = step, -step
            rest = (Ti.double(), Ti.double(), mi.double())
            fd = (tpg._edge_r(*plus, *rest) - tpg._edge_r(*minus, *rest)) / (2 * h)
            np.testing.assert_allclose(J[:, :, k].numpy(), fd.numpy(), atol=1e-4)


@pytest.mark.parametrize("bad_edges,noise,dmax", [(0, 0.05, 0.3), (2, 0.03, 0.07)])
def test_optimize_pose_graph_matches_jax(bad_edges, noise, dmax):
    """A noisy 8-node ring with three good loop closures and corrupted ones:
    the optimized poses and the kept edges against JAX's."""
    gt, graph = jax_lie_tests.TestPoseGraph()._ring_graph(np.random.default_rng(51), n=8, noise=noise,
                                             bad_edges=bad_edges)
    with x32():
        want = jpg.optimize_pose_graph(graph, max_correspondence_distance=dmax)
    got = tpg.optimize_pose_graph(graph, max_correspondence_distance=dmax, device="cpu")
    assert [p.dtype for p in got.poses] == [np.float32] * 8
    np.testing.assert_allclose(np.stack(got.poses), np.stack(want.poses), atol=1e-5)
    assert [(e.source, e.target) for e in got.edges] == [(e.source, e.target) for e in want.edges]
    if bad_edges:
        assert len(got.edges) < len(graph.edges)
    assert tate.ate_rmse(got.poses, gt, device="cpu") < tate.ate_rmse(graph.poses, gt,
                                                                       device="cpu")


def test_optimize_pose_graph_under_no_grad():
    """The CLIs run in no-grad mode: the Jacobians (``torch.func.jacrev``)
    and so the optimized poses are the same inside ``torch.no_grad()``."""
    _, graph = jax_lie_tests.TestPoseGraph()._ring_graph(np.random.default_rng(51), n=8,
                                                         noise=0.03, bad_edges=2)
    want = tpg.optimize_pose_graph(graph, max_correspondence_distance=0.3, device="cpu")
    with torch.no_grad():
        got = tpg.optimize_pose_graph(graph, max_correspondence_distance=0.3, device="cpu")
    np.testing.assert_array_equal(np.stack(got.poses), np.stack(want.poses))
    assert [(e.source, e.target) for e in got.edges] == [(e.source, e.target) for e in want.edges]


def test_ate_rmse_matches_jax(rng):
    poses = [T.integrate_trans(T.rotation_matrix(3, 1.0, rng), T.translation_matrix(1.0, rng))
             for _ in range(6)]
    offset = T.integrate_trans(T.rotation_matrix(3, 1.0, rng), T.translation_matrix(3.0, rng))
    noisy = [offset @ p @ T.integrate_trans(np.eye(3), T.translation_matrix(0.05, rng))
             for p in poses]
    with x32():
        want = [jate.ate_rmse(noisy, poses), jate.ate_rmse(poses, poses)]
    got = [tate.ate_rmse(noisy, poses, device="cpu"), tate.ate_rmse(poses, poses, device="cpu")]
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[1] < 1e-3 and got[0] > 1.0


def fragment_scene(rng, num_frag=4, n_world=1400, n_pts=800):
    """Fragments as overlapping views of one cloud (``make_scene`` of the
    JAX tests, denser: about 57% of a pair's points are shared, so that loop
    closures pass the 0.30 overlap gate). Returns (gt poses, {i: points})."""
    world = rng.uniform(-2, 2, (n_world, 3))
    poses = [np.eye(4)]
    for _ in range(num_frag - 1):
        poses.append(poses[-1] @ T.integrate_trans(T.rotation_matrix(3, 0.03, rng),
                                                   T.translation_matrix(0.4, rng)))
    frags = {}
    for i, pose in enumerate(poses):
        sel = rng.choice(n_world, n_pts, replace=False)
        local = T.transform(world[sel], np.linalg.inv(pose))
        frags[i] = local + rng.normal(size=local.shape) * 0.002
    return poses, frags


def test_multi_scale_icp_matches_jax(rng):
    pts = rng.uniform(-1, 1, (2000, 3))
    gt = T.integrate_trans(T.rotation_matrix(3, 0.02, rng), T.translation_matrix(0.1, rng))
    kw = dict(voxel_sizes=(0.2, 0.1, 0.05), max_iters=(30, 20, 10), distance_threshold=0.3)
    with x32():
        want_t, want_i = jreg.multi_scale_icp(pts, T.transform(pts, gt), np.eye(4), **kw)
    got_t, got_i = treg.multi_scale_icp(pts, T.transform(pts, gt), np.eye(4), device="cpu", **kw)
    assert got_t.dtype == np.float32 and got_i.shape == (6, 6)
    np.testing.assert_allclose(got_t, want_t, atol=1e-5)
    np.testing.assert_allclose(got_i, want_i, rtol=1e-5, atol=1e-5 * np.abs(want_i).max())
    np.testing.assert_allclose(got_t, gt, atol=0.02)


@pytest.fixture(scope="module")
def pose_graph_case():
    """Four fragments with noisy pairwise results, a garbage loop closure
    (0, 3) with no overlap support and an exact identity (1, 3): the port's
    ``build_pose_graph`` and ``refine_and_reoptimize`` beside JAX's."""
    rng = np.random.default_rng(51)
    gt, frags = fragment_scene(rng)
    pairwise = {}
    for i in range(4):
        for j in range(i + 1, 4):
            noise = T.integrate_trans(T.rotation_matrix(3, 0.002, rng),
                                      T.translation_matrix(0.01, rng))
            pairwise[(i, j)] = noise @ np.linalg.inv(gt[j]) @ gt[i]
    pairwise[(0, 3)] = T.integrate_trans(T.rotation_matrix(3, 1.0, rng),
                                         T.translation_matrix(5.0, rng))
    pairwise[(1, 3)] = np.eye(4)
    kw = dict(icp_distance=0.1, max_correspondence_distance=0.1)
    with x32():
        built = jreg.build_pose_graph(4, pairwise, frags, jreg.MultiwayConfig(**kw))
        refined = jreg.refine_and_reoptimize(built, frags, jreg.MultiwayConfig(**kw))
    t_built = treg.build_pose_graph(4, pairwise, frags, treg.MultiwayConfig(**kw), device="cpu")
    t_refined = treg.refine_and_reoptimize(t_built, frags, treg.MultiwayConfig(**kw),
                                           device="cpu")
    return gt, {"build": (built, t_built), "refine": (refined, t_refined)}


@pytest.mark.parametrize("stage", ["build", "refine"])
def test_pose_graph_assembly_matches_jax(pose_graph_case, stage):
    gt, graphs = pose_graph_case
    want, got = graphs[stage]
    edges = [(e.source, e.target) for e in got.edges]
    assert edges == [(e.source, e.target) for e in want.edges]
    # the odometry chain and the good loop closure (0, 2), (1, 2)... kept;
    # the garbage (0, 3) dropped by the overlap gate, (1, 3) as the identity
    assert (0, 2) in edges and (0, 3) not in edges and (1, 3) not in edges
    assert [e.uncertain for e in got.edges] == [e.uncertain for e in want.edges]
    np.testing.assert_allclose(np.stack(got.poses), np.stack(want.poses), atol=1e-5)
    for e, w in zip(got.edges, want.edges):
        np.testing.assert_allclose(e.information, w.information, rtol=1e-5,
                                   atol=1e-5 * np.abs(w.information).max())
        np.testing.assert_allclose(e.transformation, w.transformation, atol=1e-5)
    with x32():
        want_ate = jate.ate_rmse(want.poses, gt)
    got_ate = tate.ate_rmse(got.poses, gt, device="cpu")
    assert abs(got_ate - want_ate) < 1e-4 and got_ate < 3.0


@pytest.mark.parametrize("num_node", [300, 700])
def test_redwood_samples_bit_for_bit(tmp_path, num_node):
    """Every pair's sample (500-point fragments: sampled without replacement
    at 300, with it at 700) and the loader's poses and keys, as JAX's."""
    root = str(tmp_path / "redwood")
    write_fake_redwood(root, np.random.default_rng(51), num_frag=4, n_pts=500)
    want = JaxRedwood(root, SCENE, num_node=num_node)
    got = RedwoodDataset(root, SCENE, num_node=num_node, device="cpu")
    assert got.keys == want.keys and got.num_pcds == want.num_pcds == 4
    assert [got.pair_ids(i) for i in range(len(got))] == [want.pair_ids(i) for i in range(6)]
    for a, b in zip(got.gt_trajectory, want.gt_trajectory):
        np.testing.assert_array_equal(a, b)
    for i in range(len(got)):
        s, w = got[i], want[i]
        assert sorted(s) == sorted(w) and s["key"] == w["key"]
        for k in ("corr_pos", "src_keypts", "tgt_keypts", "gt_trans", "gt_labels"):
            np.testing.assert_array_equal(s[k], w[k])
    np.testing.assert_array_equal(got._load(2)[1], want._load(2)[1])


def test_redwood_protocol_matches_jax(tmp_path, rng):
    """The .log writer and reader, the .info reader, Shepperd quaternions in
    all four branches, the weighted error and ``evaluate_registration``."""
    poses = [T.integrate_trans(T.rotation_matrix(3, 180.0, rng), T.translation_matrix(2.0, rng))
             for _ in range(5)]
    keys = [(i, i + 2, 5) for i in range(5)]
    tproto.write_trajectory(str(tmp_path / "t.log"), poses, keys)
    jproto.write_trajectory(str(tmp_path / "j.log"), poses, keys)
    assert (tmp_path / "t.log").read_text() == (tmp_path / "j.log").read_text()
    got, want = tproto.read_trajectory(str(tmp_path / "t.log")), \
        jproto.read_trajectory(str(tmp_path / "t.log"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

    infos = []
    with open(tmp_path / "x.info", "w") as f:
        for i in range(4):
            B = rng.normal(size=(6, 6))
            infos.append(B @ B.T + np.eye(6))
            f.write(f"{i} {i + 2} 6\n")
            f.write("".join("\t".join(f"{v:.10f}" for v in row) + "\n" for row in infos[-1]))
    n_t, cov_t = tproto.read_trajectory_info(str(tmp_path / "x.info"))
    n_j, cov_j = jproto.read_trajectory_info(str(tmp_path / "x.info"))
    assert n_t == n_j == 6
    np.testing.assert_array_equal(cov_t, cov_j)

    for R in [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
              np.diag([-1.0, -1.0, 1.0])] + [T.rotation_matrix(3, 180.0, rng) for _ in range(8)]:
        np.testing.assert_array_equal(tproto.rotation_to_quaternion(R),
                                      jproto.rotation_to_quaternion(R))

    n = 6
    gt_pairs = np.array([(i, j, n) for i in range(n) for j in range(i + 1, n)])
    gt = np.stack([T.integrate_trans(T.rotation_matrix(3, 30.0, rng),
                                     T.translation_matrix(1.0, rng)) for _ in gt_pairs])
    gt_info = np.stack([infos[k % 4] for k in range(len(gt_pairs))])
    # every other pair exact (good), the rest off by a random rotation and 20 cm (bad)
    result = gt @ np.stack([T.integrate_trans(T.rotation_matrix(3, 4.0 * (k % 2), rng),
                                              T.translation_matrix(0.2 * (k % 2), rng))
                            for k in range(len(gt_pairs))])
    for k in range(len(gt_pairs)):
        e_t = tproto.transformation_error(np.linalg.inv(gt[k]) @ result[k], gt_info[k])
        assert e_t == jproto.transformation_error(np.linalg.inv(gt[k]) @ result[k], gt_info[k])
    args = (n, result, gt_pairs, gt_pairs, gt, gt_info)
    got, want = tproto.evaluate_registration(*args), jproto.evaluate_registration(*args)
    assert got == want and 0 < got[1] < 1 and 0 < got[0] < 1
    extra = np.concatenate([gt_pairs, [[0, 1, n]]])  # consecutive: not in the tested set
    args = (n, np.concatenate([result, result[:1]]), extra, gt_pairs, gt, gt_info)
    assert tproto.evaluate_registration(*args) == jproto.evaluate_registration(*args)
