"""The port's default eval configuration as a whole, against the JAX package
on the same numpy inputs: the default fused forward (whole-layer kernels'
plain versions here) and the half-precision one at full width with the
Synthetic snapshot, the regime guard, the Evaluator, and the numpy helpers
the Evaluator rests on.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.data import SyntheticPairDataset
from pointdsc_tpu.data import pipeline as j_pipe
from pointdsc_tpu.eval import metrics as j_metrics
from pointdsc_tpu.eval import protocol as j_proto
from pointdsc_tpu.eval.runner import Evaluator as JaxEvaluator
from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu.models import regime as j_regime
from pointdsc_tpu.train.trainer import load_model_weights
from pointdsc_tpu_torch import Evaluator, PointDSC, load_pretrained
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.data import pipeline as t_pipe
from pointdsc_tpu_torch.eval import metrics as t_metrics
from pointdsc_tpu_torch.eval import protocol as t_proto
from pointdsc_tpu_torch.models import regime as t_regime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAP = os.path.join(ROOT, "snapshot", "PointDSC_Synthetic_release")
N = 512


@pytest.fixture(autouse=True)
def no_grad():
    """Grad mode is the caller's: these tests run the eval forward without."""
    with torch.no_grad():
        yield


def inputs(masked, n=N, seed=3):
    """One synthetic pair; masked: 480 real points padded to 512. The
    snapshot's offset-softmax slack depends on the pair: seed 3 is in regime
    (17 nats), seed 7 far out of it (140 nats)."""
    ex = SyntheticPairDataset(num_pairs=1, num_corr=480 if masked else n, seed=seed)[0]
    arrs = [ex[k] for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    if masked:
        arrs = [np.concatenate([a, np.zeros((n - 480, a.shape[1]), a.dtype)]) for a in arrs]
    mask = (np.arange(n) < 480)[None] if masked else None
    return [np.asarray(a, np.float32)[None] for a in arrs], mask


def to_torch_model(variables, **kw):
    tm = PointDSC(device="cpu", **kw)
    tm.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                       strict=True)
    return tm


@pytest.fixture(scope="module")
def snapshot():
    """The JAX model (default flags: offset_softmax=True) with the Synthetic
    snapshot's weights, and the same weights in the port's default model."""
    jm = JaxPointDSC(in_dim=6, num_layers=12, num_channels=128, k=40)
    (cp, src, tgt), _ = inputs(False)
    variables = load_model_weights(jm, os.path.join(SNAP, "models", "model_best.pkl"),
                                   (jnp.asarray(cp), jnp.asarray(src), jnp.asarray(tgt)))
    return jm, variables, to_torch_model(variables)


def inflate_keys(variables, factor=100.0):
    """Every projection_k scaled by ``factor``: the key norms and with them
    the bound's slack grow by it (tests/test_offset_regime.py's recipe)."""
    enc = dict(variables["params"]["encoder"])
    for name in list(enc):
        if name.startswith("NonLocal_layer_"):
            layer = dict(enc[name])
            layer["projection_k"] = {k: v * factor for k, v in layer["projection_k"].items()}
            enc[name] = layer
    return {**variables, "params": {**variables["params"], "encoder": enc}}


@pytest.fixture(scope="module")
def small():
    """3 random layers at C = 128, N = 256 (tests/test_offset_regime.py's
    set-up), in both frameworks."""
    jm = JaxPointDSC(in_dim=6, num_layers=3, num_channels=128, k=20, ratio=0.1)
    s = SyntheticPairDataset(num_pairs=1, num_corr=256, seed=0)[0]
    args = tuple(jnp.asarray(s[k])[None] for k in ("corr_pos", "src_keypts", "tgt_keypts"))
    variables = jm.init(jax.random.key(0), *args)
    return jm, variables, s


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("masked", [False, True])
def test_default_fused_forward_matches_jax(snapshot, masked):
    """PointDSC(offset_softmax=True), fused, against JAX's default fused
    forward (whole-layer Pallas kernels in interpret mode), on a pair inside
    the offset softmax's regime. final_trans atol 1e-3 (measured 2.0e-4 and
    2.4e-5) and label agreement > 0.99 (measured 1.0): the bound of the
    running-max fused test. Normalised features atol 2e-2 (measured 5.4e-3
    and 6.4e-3 against entries of ~0.09): q, k, v and p are bf16 on both
    sides, one of them that rounds the other way moves a trained layer's
    sharp softmax, and twelve layers amplify it (two random layers agree to
    1e-6, tests/test_torch_encoder_layer.py)."""
    jm, variables, tm = snapshot
    arrs, mask = inputs(masked)
    mj = None if mask is None else jnp.asarray(mask)
    oj = jm.apply(variables, *(jnp.asarray(a) for a in arrs), mask=mj, testing=True,
                  fused_attention=True)
    ot = tm(*(torch.from_numpy(a) for a in arrs),
            mask=None if mask is None else torch.from_numpy(mask), fused=True)
    np.testing.assert_allclose(ot.normed_features.numpy(), np.asarray(oj.normed_features),
                               atol=2e-2)
    np.testing.assert_allclose(ot.final_trans.numpy(), np.asarray(oj.final_trans), atol=1e-3)
    assert (ot.final_labels.numpy() == np.asarray(oj.final_labels)).mean() > 0.99
    assert len(tm._fold_cache) == 12


def test_half_precision_forward_matches_jax(snapshot):
    """half_precision=True: the per-op encoder with bf16 Dense products and
    the offset attention kernel, against JAX's. Twelve layers of bf16
    activations (2^-9 relative per rounding) and two frameworks' bf16 matmuls
    that round at other places: the normalised features agree to 6e-2
    (measured 2.4e-2 against entries of ~0.09), the transform to 1e-3
    (measured 7.0e-5), the labels on > 0.99 of the points (measured 1.0)."""
    jm, variables, _ = snapshot
    arrs, _ = inputs(False)
    jh = jm.clone(half_precision=True)
    oj = jh.apply(variables, *(jnp.asarray(a) for a in arrs), testing=True, fused_attention=True)
    th = to_torch_model(variables, half_precision=True)
    ot = th(*(torch.from_numpy(a) for a in arrs), fused=True)
    assert ot.normed_features.dtype == torch.float32
    assert not th._fold_cache  # the whole-layer kernels did not run
    feats_j = np.asarray(oj.normed_features.astype(jnp.float32))
    np.testing.assert_allclose(ot.normed_features.numpy(), feats_j, atol=6e-2)
    np.testing.assert_allclose(ot.final_trans.numpy(), np.asarray(oj.final_trans), atol=1e-3)
    assert (ot.final_labels.numpy() == np.asarray(oj.final_labels)).mean() > 0.99


def test_state_dict_layout_is_unchanged(snapshot):
    """The flags add no parameter: a state dict saved before the model had
    them (this explicit key list) loads with strict=True whatever the
    configuration, and the snapshot loads through load_pretrained."""
    keys = ["sigma", "encoder.layer0.weight", "encoder.layer0.bias"]
    bn = ("weight", "bias", "running_mean", "running_var")
    for i in range(12):
        p, n = f"encoder.PointCN_layer_{i}", f"encoder.NonLocal_layer_{i}"
        keys += [f"{p}.Dense_0.weight", f"{p}.Dense_0.bias"]
        keys += [f"{p}.MaskedBatchNorm_0.{b}" for b in bn]
        for name in ("projection_q", "projection_k", "projection_v"):
            keys += [f"{n}.{name}.weight", f"{n}.{name}.bias"]
        for j in (0, 1):
            keys += [f"{n}.fc_message_{j}.weight", f"{n}.fc_message_{j}.bias"]
            keys += [f"{n}.fc_message_bn{j}.{b}" for b in bn]
        keys += [f"{n}.fc_message_2.weight", f"{n}.fc_message_2.bias"]
    for i in range(3):
        keys += [f"classification_{i}.weight", f"classification_{i}.bias"]
    _, _, tm = snapshot
    old = tm.state_dict()
    assert list(old) == keys
    for kw in ({}, {"offset_softmax": False}, {"half_precision": True}):
        PointDSC(device="cpu", **kw).load_state_dict(old, strict=True)
    loaded = load_pretrained(SNAP, device="cpu", half_precision=True)
    assert loaded.half_precision and loaded.offset_softmax
    assert all(torch.equal(loaded.state_dict()[k], old[k]) for k in keys)


# ------------------------------------------------------------------ the regime

def test_offset_regime_slack_matches_jax(snapshot, small):
    """The dense replay on the same weights and pair: atol 1e-3 nats (plus
    rtol 1e-5 out of regime, where the slack is in the hundreds), on the
    snapshot (masked and not; measured 17.85 and 17.36 nats, equal to 2e-6)
    and on random weights in and out of regime (1.09 and 108.9 nats)."""
    jm, variables, tm = snapshot
    for masked in (False, True):
        arrs, mask = inputs(masked)
        want = j_regime.offset_regime_slack(
            jm, variables, *(jnp.asarray(a) for a in arrs),
            mask=None if mask is None else jnp.asarray(mask))
        got = t_regime.offset_regime_slack(
            tm, *(torch.from_numpy(a) for a in arrs),
            mask=None if mask is None else torch.from_numpy(mask), chunk=128)
        assert abs(got - want) < 1e-3, (got, want)
        assert got < t_regime.OFFSET_REGIME_MAX_SLACK
    sj, sv, s = small
    args = [np.asarray(s[k])[None] for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    for vs in (sv, inflate_keys(sv)):
        want = j_regime.offset_regime_slack(sj, vs, *(jnp.asarray(a) for a in args))
        got = t_regime.offset_regime_slack(
            to_torch_model(vs, num_layers=3, k=20), *(torch.from_numpy(a) for a in args))
        assert abs(got - want) < 1e-3 + 1e-5 * abs(want), (got, want)


def test_select_attention_kernels(snapshot, small):
    """No flip on the Synthetic snapshot; a flip on weights scaled out of
    regime, to a copy that shares the parameters; a no-op on a model that
    already runs the running-max kernel."""
    _, _, tm = snapshot
    arrs, _ = inputs(False)
    targs = [torch.from_numpy(a) for a in arrs]
    model, slack, flipped = t_regime.select_attention_kernels(tm, *targs)
    assert model is tm and not flipped and 0.0 < slack < t_regime.OFFSET_REGIME_MAX_SLACK
    _, sv, s = small
    bad = to_torch_model(inflate_keys(sv), num_layers=3, k=20)
    sargs = [torch.from_numpy(np.asarray(s[k]))[None]
             for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    model, slack, flipped = t_regime.select_attention_kernels(bad, *sargs)
    assert flipped and slack >= t_regime.OFFSET_REGIME_MAX_SLACK
    assert model is not bad and model.offset_softmax is False and bad.offset_softmax is True
    assert model.encoder is bad.encoder
    assert t_regime.select_attention_kernels(model, *sargs) == (model, 0.0, False)


# ------------------------------------------------------------------ the Evaluator

def test_evaluator_matches_jax(snapshot):
    """run_dataset on 4 synthetic pairs (400 points, padded to the 512
    bucket) against the JAX Evaluator with fused_attention=True: the ten
    columns that are not times. success, the counts, the ratio and the scene
    index are equal; RE within 0.05 degrees and TE within 0.05 cm (the 1e-3
    bound of the forward, in the protocol's units); precision, recall and F1
    within 0.01 (labels agree on > 0.99 of the points)."""
    jm, variables, tm = snapshot
    ds = SyntheticPairDataset(num_pairs=4, num_corr=400, seed=3)
    scene_of = lambda i: i % 2
    js, jagg = JaxEvaluator(jm, variables, fused_attention=True).run_dataset(
        ds, scene_of=scene_of, verbose=False)
    ev = Evaluator(tm, fused_attention=True, device="cpu")
    ts, tagg = ev.run_dataset(ds, scene_of=scene_of, verbose=False)
    assert ts.shape == js.shape == (4, 12)
    assert not ev.flipped and ev.model is tm and 0.0 < ev.last_slack < 60.0
    for col in (0, 3, 4, 5, 11):
        np.testing.assert_array_equal(ts[:, col], js[:, col])
    np.testing.assert_allclose(ts[:, 1], js[:, 1], atol=0.05)
    np.testing.assert_allclose(ts[:, 2], js[:, 2], atol=0.05)
    np.testing.assert_allclose(ts[:, 6:9], js[:, 6:9], atol=0.01)
    assert (ts[:, 9] > 0).all() and (ts[:, 10] >= 0).all()
    assert tagg["pair_recall"] == jagg["pair_recall"] == 100.0
    assert [r["num_pairs"] for r in tagg["scenes"]] == [2, 2]


def test_evaluator_guard_flips(small):
    """Weights scaled out of regime: the first probe switches the Evaluator
    to the running-max kernel before any recorded forward, and the result is
    the dense forward's (atol 5e-3, the JAX suite's bound for this case)."""
    _, sv, s = small
    bad = to_torch_model(inflate_keys(sv), num_layers=3, k=20)
    ev = Evaluator(bad, fused_attention=True, device="cpu")
    _, trans = ev.run_pair(dict(s))
    assert ev.flipped and ev.model.offset_softmax is False and ev.last_slack >= 60.0
    args = [torch.from_numpy(np.asarray(s[k]))[None]
            for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    ref = bad(*args, mask=torch.ones((1, 256), dtype=torch.bool), fused=False)
    np.testing.assert_allclose(trans, ref.final_trans[0].numpy(), atol=5e-3, rtol=0)
    # a second pair in the same bucket: no probe is left, nothing flips back
    ev.run_pair(dict(s))
    assert ev.model.offset_softmax is False and ev._regime_probes_left == 0


def test_evaluator_second_pair_violation_flips(small):
    """The slack depends on the pair: a violation that only the second pair
    shows (same bucket, coordinates scaled by 50) still flips."""
    _, sv, s = small
    ev = Evaluator(to_torch_model(sv, num_layers=3, k=20), fused_attention=True, device="cpu")
    ev.run_pair(dict(s))
    assert ev.model.offset_softmax is True
    bad = {k: (np.asarray(v) * 50.0 if k in ("corr_pos", "src_keypts", "tgt_keypts") else v)
           for k, v in s.items()}
    ev.run_pair(bad)
    assert ev.flipped and ev.model.offset_softmax is False


@pytest.mark.parametrize("kw", [{"solver": "RANSAC"}, {"solver": "RANSAC", "use_icp": True},
                                {"sp_mesh": object()}])
def test_evaluator_refuses_what_is_not_ported(small, kw):
    """The sequence-parallel mesh raises, naming the module it needs.
    solver='RANSAC', refused until the classical baselines were ported, now
    runs, with or without ICP: it registers the pair and re-solves the
    model's transform by RANSAC on the model's inliers (4096 hypotheses from
    a generator seeded 51 on every forward, so a second run is the same)."""
    if "sp_mesh" in kw:
        model = PointDSC(num_layers=1, num_channels=16, device="cpu")
        with pytest.raises(NotImplementedError, match="seq_parallel"):
            Evaluator(model, device="cpu", **kw)
        Evaluator(model, device="cpu", use_icp=True, icp_threshold=0.2)
        return
    _, sv, s = small
    model = to_torch_model(sv, num_layers=3, k=20)
    ev = Evaluator(model, device="cpu", icp_threshold=0.1, **kw)
    row, trans = ev.run_pair(dict(s))
    again, trans2 = ev.run_pair(dict(s))
    assert row[0] == 1.0 and np.array_equal(trans, trans2)
    assert np.array_equal(row[:9], again[:9])
    _, svd = Evaluator(model, device="cpu", icp_threshold=0.1,
                       use_icp=kw.get("use_icp", False)).run_pair(dict(s))
    assert np.abs(trans - svd).max() < 0.05 and trans.shape == (4, 4)


def test_evaluator_refuses_sharded_and_unknown_solver():
    model = PointDSC(num_layers=1, num_channels=16, device="cpu")
    with pytest.raises(NotImplementedError):
        Evaluator(model, device="cpu").run_dataset_sharded([])
    with pytest.raises(ValueError):
        Evaluator(model, device="cpu", solver="LM")


# ------------------------------------------------------------------ numpy helpers

@pytest.mark.parametrize("n", [1, 256, 257, 1000, 5000, 5120, 6145, 12000, 24576, 24577, 30000])
def test_bucket_size(n):
    assert t_pipe.bucket_size(n) == j_pipe.bucket_size(n)
    assert t_pipe._BUCKETS == j_pipe._BUCKETS


@pytest.mark.parametrize("n,n_pad", [(100, None), (256, None), (300, 1024), (700, None)])
def test_pad_to_bucket(rng, n, n_pad):
    sample = {"corr_pos": rng.normal(size=(n, 6)).astype(np.float32),
              "src_keypts": rng.normal(size=(n, 3)).astype(np.float32),
              "tgt_keypts": rng.normal(size=(n, 3)).astype(np.float32),
              "gt_labels": (rng.uniform(size=n) > 0.5).astype(np.float32),
              "gt_trans": np.eye(4, dtype=np.float32)}
    got, want = t_pipe.pad_to_bucket(sample, n_pad), j_pipe.pad_to_bucket(sample, n_pad)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    both = [t_pipe.collate_batch([sample, sample]), j_pipe.collate_batch([sample, sample])]
    for k in both[1]:
        np.testing.assert_array_equal(both[0][k], both[1][k])


@pytest.mark.parametrize("seed,masked", [(0, False), (1, False), (2, True), (3, True)])
def test_pair_stats(seed, masked):
    rng = np.random.default_rng(seed)
    ex = SyntheticPairDataset(num_pairs=1, num_corr=200, seed=seed)[0]
    pred = ex["gt_trans"].copy()
    pred[:3, 3] += rng.normal(size=3) * (0.01 if seed % 2 else 1.0)
    labels = (rng.uniform(size=200) > 0.5).astype(np.float32)
    mask = (np.arange(200) < 150) if masked else None
    args = (pred, labels, ex["gt_trans"], ex["gt_labels"], 15.0, 30.0, 0.25, 0.5, seed)
    np.testing.assert_array_equal(t_proto.pair_stats(*args, mask=mask),
                                  j_proto.pair_stats(*args, mask=mask))
    assert t_proto.STATS_COLUMNS == j_proto.STATS_COLUMNS


@pytest.mark.parametrize("pairs", [0, 1, 7])
def test_aggregate_stats(pairs):
    rng = np.random.default_rng(pairs)
    stats = rng.uniform(size=(pairs, 12))
    if pairs:
        stats[:, 0] = rng.uniform(size=pairs) > 0.4
        stats[:, 11] = rng.integers(0, 3, size=pairs)
    names = ["a", "b", "c"]
    got, want = t_proto.aggregate_stats(stats, names), j_proto.aggregate_stats(stats, names)
    assert got.keys() == want.keys()
    assert got["scenes"] == want["scenes"]
    for k in want:
        if k != "scenes":
            assert got[k] == want[k]
    if pairs:
        assert t_proto.format_scene_report(got) == j_proto.format_scene_report(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_auc_and_euler(seed):
    rng = np.random.default_rng(seed)
    errors = rng.exponential(5.0, size=50)
    assert t_metrics.exact_auc(errors, [5, 10, 20]) == j_metrics.exact_auc(errors, [5, 10, 20])
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    np.testing.assert_array_equal(t_metrics.rot_to_euler(q), j_metrics.rot_to_euler(q))
