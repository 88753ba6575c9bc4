"""ICP, the registration information matrix, descriptor matching and the
Evaluator with ICP: the port (plain versions on the CPU) against the JAX
package on the same numpy-seeded float32 inputs and the same weights."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.data import SyntheticPairDataset
from pointdsc_tpu.eval.runner import Evaluator as JaxEvaluator
from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu.ops import icp as j_icp
from pointdsc_tpu.ops import matching as j_match
from pointdsc_tpu.train.trainer import load_model_weights
from pointdsc_tpu_torch import Evaluator, load_pretrained
from pointdsc_tpu_torch.kernels import nn_search as t_nn
from pointdsc_tpu_torch.ops import icp as t_icp
from pointdsc_tpu_torch.ops import matching as t_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAP = os.path.join(ROOT, "snapshot", "PointDSC_Synthetic_release")


def rot(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.deg2rad(deg)
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def icp_case(rng, n=400, m=500, deg=4.0, shift=0.04):
    """A target cloud on a few surfaces of a 1 m box, the source the same
    surfaces resampled, moved by gt^-1 (noise 3 mm), and an initial guess
    off gt by `deg` degrees and `shift` metres."""
    def surface(count):
        pts = rng.uniform(0.0, 1.0, size=(count, 3))
        face = rng.integers(0, 3, size=count)
        pts[np.arange(count), face] = 0.0
        bump = np.linalg.norm(pts - 0.5, axis=1) < 0.3
        pts[bump, 2] += 0.1  # a raised patch, so the fit is not degenerate
        return pts

    gt = np.eye(4)
    gt[:3, :3] = rot(rng, 20.0)
    gt[:3, 3] = rng.normal(size=3) * 0.2
    tgt = surface(m) @ gt[:3, :3].T + gt[:3, 3]
    src = surface(n) + rng.normal(scale=0.003, size=(n, 3))
    init = gt.copy()
    init[:3, :3] = rot(rng, deg) @ gt[:3, :3]
    init[:3, 3] += shift * rng.normal(size=3) / np.sqrt(3)
    return src.astype(np.float32), tgt.astype(np.float32), init.astype(np.float32), gt


def run_both(src, tgt, init, thr=0.1, iters=20, src_mask=None, tgt_mask=None):
    masks_j = [None if m is None else jnp.asarray(m) for m in (src_mask, tgt_mask)]
    masks_t = [None if m is None else torch.from_numpy(m) for m in (src_mask, tgt_mask)]
    j = j_icp.icp_point_to_point(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init),
                                 max_correspondence_distance=thr, max_iters=iters,
                                 src_mask=masks_j[0], tgt_mask=masks_j[1])
    t = t_icp.icp_point_to_point(torch.from_numpy(src), torch.from_numpy(tgt),
                                 torch.from_numpy(init), max_correspondence_distance=thr,
                                 max_iters=iters, src_mask=masks_t[0], tgt_mask=masks_t[1])
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("masked", [False, True])
def test_icp_matches_jax(rng, masked):
    """Transform within 1e-4 (the same correspondences; Procrustes in the
    same closed form; the distances of the port's search and JAX's dense
    matrix differ in the last bits), fitness equal, rmse within 1e-5."""
    src, tgt, init, gt = icp_case(rng)
    sm = (np.arange(len(src)) < len(src) - 40) if masked else None
    tm = (np.arange(len(tgt)) % 7 != 0) if masked else None
    (jt, jf, jr), (tt, tf, tr) = run_both(src, tgt, init, src_mask=sm, tgt_mask=tm)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    assert tf == pytest.approx(float(jf), abs=1e-6)
    assert tr == pytest.approx(float(jr), abs=1e-5)
    # it moved towards gt: both clouds are sparse samples of the surfaces
    assert np.abs(tt - gt).max() < 0.5 * np.abs(init - gt).max()


def test_icp_fitness_and_rmse_are_the_last_search(rng):
    """fitness and rmse come from the last iteration's search, i.e. against
    the transform of iteration k - 1, not the returned one."""
    src, tgt, init, _ = icp_case(rng, deg=8.0, shift=0.08)
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    prev, _, _ = t_icp.icp_point_to_point(s, t, torch.from_numpy(init), 0.1, max_iters=2)
    trans, fitness, rmse = t_icp.icp_point_to_point(s, t, torch.from_numpy(init), 0.1, max_iters=3)
    warped = s @ prev[:3, :3].T + prev[:3, 3]
    d2 = torch.cdist(warped.double(), t.double()).min(dim=1).values ** 2
    matched = d2 < 0.01
    assert float(fitness) == pytest.approx(float(matched.float().mean()), abs=1e-6)
    assert float(rmse) == pytest.approx(float(torch.sqrt(d2[matched].mean())), abs=1e-5)
    assert not torch.allclose(trans, prev)


def test_icp_freezes_without_matches(rng):
    """Fewer than 3 matches: the transform stays the initial one, exactly, in
    both packages; fitness 0, rmse 0."""
    src, tgt, init, _ = icp_case(rng, deg=30.0, shift=1.0)
    (jt, jf, jr), (tt, tf, tr) = run_both(src, tgt, init, thr=1e-4)
    np.testing.assert_array_equal(tt, init)
    np.testing.assert_array_equal(jt, init)
    assert tf == jf == 0.0 and tr == jr == 0.0


def test_icp_clamps_coincident_points(rng):
    """The source is the target moved by ~1e-6: the search's unclamped d2 is
    rounding noise of either sign (asserted), which without the clamp could
    make the rmse sqrt(negative). Both give a finite rmse below 1e-3 and
    fitness 1."""
    _, tgt, _, _ = icp_case(rng)
    tgt = tgt * np.float32(7.0)  # larger coordinates, larger cancellation
    src = (tgt + rng.normal(scale=1e-6, size=tgt.shape)).astype(np.float32)
    raw, _ = t_nn.nearest_neighbors(torch.from_numpy(src), torch.from_numpy(tgt))
    assert float(raw.min()) < 0.0
    eye = np.eye(4, dtype=np.float32)
    (jt, jf, jr), (tt, tf, tr) = run_both(src, tgt, eye)
    assert np.isfinite(tr) and 0.0 <= tr < 1e-3 and np.isfinite(jr)
    assert tf == jf == 1.0
    np.testing.assert_allclose(tt, eye, atol=1e-5)


def test_icp_batch_is_its_rows(rng):
    """A batch runs one search per iteration for every pair; its result is
    each pair's own."""
    cases = [icp_case(rng) for _ in range(2)]
    src, tgt, init = (torch.from_numpy(np.stack([c[i] for c in cases])) for i in range(3))
    mask = torch.ones(src.shape[:2], dtype=torch.bool)
    mask[1, -30:] = False
    bt, bf, br = t_icp.icp_point_to_point(src, tgt, init, 0.1, src_mask=mask,
                                          tgt_mask=torch.ones(tgt.shape[:2], dtype=torch.bool))
    for i in range(2):
        ot, of, orr = t_icp.icp_point_to_point(src[i], tgt[i], init[i], 0.1, src_mask=mask[i])
        torch.testing.assert_close(bt[i], ot, atol=1e-6, rtol=0)
        assert float(bf[i]) == pytest.approx(float(of)) and float(br[i]) == pytest.approx(float(orr))


@pytest.mark.parametrize("masked", [False, True])
def test_information_matrix_matches_jax(rng, masked):
    """Relative 1e-5 of the largest entry; the [5, 5] count equal."""
    src, tgt, _, gt = icp_case(rng)
    sm = (np.arange(len(src)) % 5 != 0) if masked else None
    g = gt.astype(np.float32)
    ref = np.asarray(j_icp.information_matrix(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(g), 0.05,
        src_mask=None if sm is None else jnp.asarray(sm)))
    out = t_icp.information_matrix(torch.from_numpy(src), torch.from_numpy(tgt),
                                   torch.from_numpy(g), 0.05,
                                   src_mask=None if sm is None else torch.from_numpy(sm)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert out[5, 5] == ref[5, 5] > 0
    np.testing.assert_allclose(out, out.T, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("use_mutual", [False, True])
def test_match_descriptors(rng, use_mutual):
    """Equal correspondences and masks (argmax, first index on ties; a
    duplicated target descriptor makes a tie)."""
    src = rng.normal(size=(120, 33)).astype(np.float32)
    tgt = np.concatenate([src[:80] + rng.normal(scale=0.3, size=(80, 33)),
                          rng.normal(size=(60, 33))]).astype(np.float32)
    tgt[100] = tgt[3]
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    tgt /= np.linalg.norm(tgt, axis=1, keepdims=True)
    jc, jm = (np.asarray(x) for x in j_match.match_descriptors(
        jnp.asarray(src), jnp.asarray(tgt), use_mutual=use_mutual))
    tc, tm = (x.numpy() for x in t_match.match_descriptors(
        torch.from_numpy(src), torch.from_numpy(tgt), use_mutual=use_mutual))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tm, jm)
    if use_mutual:
        assert tm.any() and not tm.all()


def test_inlier_labels(rng):
    src, tgt, _, gt = icp_case(rng)
    m = min(len(src), len(tgt))
    g = gt.astype(np.float32)
    ref = np.asarray(j_match.inlier_labels(jnp.asarray(src[:m]), jnp.asarray(tgt[:m]),
                                           jnp.asarray(g), 0.3))
    out = t_match.inlier_labels(torch.from_numpy(src[:m]), torch.from_numpy(tgt[:m]),
                                torch.from_numpy(g), 0.3).numpy()
    np.testing.assert_array_equal(out, ref)


def test_evaluator_with_icp_matches_jax():
    """Evaluator(use_icp=True) on 3 Synthetic pairs (240 points, bucket 256)
    with the snapshot's weights, dense forward, against the JAX Evaluator:
    the transforms within 1e-3 (the forward's fused-vs-dense bound; the ICP
    adds 1e-4), the stats' counts equal. ICP moved the model's transform."""
    ds = SyntheticPairDataset(num_pairs=3, num_corr=240, seed=5, noise=0.01)
    jm = JaxPointDSC(in_dim=6, num_layers=12, num_channels=128, k=40)
    p = ds[0]
    variables = load_model_weights(jm, os.path.join(SNAP, "models", "model_best.pkl"),
                                   tuple(jnp.asarray(p[k])[None] for k in
                                         ("corr_pos", "src_keypts", "tgt_keypts")))
    jev = JaxEvaluator(jm, variables, use_icp=True, icp_threshold=0.1)
    tm = load_pretrained(SNAP, device="cpu")
    tev = Evaluator(tm, use_icp=True, icp_threshold=0.1, device="cpu")
    plain = Evaluator(tm, device="cpu")
    moved = 0.0
    with torch.no_grad():
        for i in range(len(ds)):
            jrow, jt = jev.run_pair(ds[i])
            trow, tt = tev.run_pair(ds[i])
            _, t0 = plain.run_pair(ds[i])
            np.testing.assert_allclose(tt, jt, atol=1e-3)
            for col in (0, 3, 4, 5):
                assert trow[col] == jrow[col]
            moved = max(moved, float(np.abs(tt - t0).max()))
    assert moved > 1e-4
