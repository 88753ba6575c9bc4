"""The seed stage after the seed k-NN, ``kernels/scoring.py::seed_hypotheses``
(hypotheses, inlier counts, selection), and the card's width and seed-count
limits lifted (C zero-padded to a multiple of the kernels' 128; any number of
seeds), on the CPU.

- ``seed_hypotheses_plain`` against the JAX model's ``_seed_transforms`` with
  ``fused=True`` (its Pallas scoring kernel in interpret mode) on the same
  seeds, neighbours, normed features and sigma: B = 2, N = 512 with 24
  masked points a sample, C = 32, k = 16, S = 51;
- the NMS seeds of a real forward of each trained snapshot (outliers, and
  masked seeds with fewer than k valid neighbours) through the port's plain
  version and JAX's, against an f64 run within each seed's tolerance;
- the model's k-NN below the seed k-NN kernel's gate against JAX's there;
- the wrappers' padding: each kernel's plain version on the operands padded
  as the card path pads them, with the scale constants of the model's width,
  against the same plain version unpadded;
- the fused port model at C = 32, k = 16 against ``tests/test_fused_model.py``'s
  JAX configuration, at that file's tolerance;
- the gate of the seed stage's kernels (``use_hypothesis_kernel``);
- the seed select beyond the 8192 seeds its kernel sorts in shared memory,
  against ``jax.lax.top_k``.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_port_cuda.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu_torch import PointDSC, load_pretrained
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import _check
from pointdsc_tpu_torch.kernels import encoder_layer as t_el
from pointdsc_tpu_torch.kernels import nms as t_nms
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.kernels import scoring as t_score
from pointdsc_tpu_torch.kernels import seed_knn as t_knn
from pointdsc_tpu_torch.kernels import sm_loss as t_sm
from pointdsc_tpu_torch.models import pointdsc as t_model
from pointdsc_tpu_torch.ops.knn import seed_knn_sorted
from pointdsc_tpu_torch.ops.nms import _total_order_key
from tests.test_model import make_synthetic_pair

B, N, N_MASKED, C, K, S = 2, 512, 24, 32, 16, 51


@pytest.fixture(autouse=True)
def no_grad():
    """Grad mode is the caller's: these tests run the eval forward without."""
    with torch.no_grad():
        yield


def stage_inputs(seed):
    """B pairs (half inliers of a rigid motion, 24 points of each masked:
    random ones in sample 0, the last ones in sample 1), unit features with
    inliers near a shared direction, seeds among the inliers (one masked
    seed in sample 1: its fitness is -1) and their k neighbours by the
    port's plain k-NN.

    The seeds are inliers, as a trained model's NMS picks confident points:
    an outlier seed among random features can be nearly degenerate, and then
    two f32 orders of its sums differ beyond a fixed 1e-4. The NMS seeds of a
    real forward, outliers included, are held to an f64 run below
    (``test_seed_trans_of_real_seeds_against_f64``)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.0, 1.0, (B, N, 3))
    tgt = np.empty_like(src)
    base = rng.normal(size=C)
    feats = rng.normal(size=(B, N, C))
    mask = np.ones((B, N), bool)
    mask[0, rng.permutation(N)[:N_MASKED]] = False
    mask[1, N - N_MASKED:] = False
    seeds = np.empty((B, S), np.int64)
    for b in range(B):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rot = q * np.sign(np.linalg.det(q))
        tgt[b] = src[b] @ rot.T + rng.normal(size=3) * 0.3 + rng.normal(size=(N, 3)) * 0.01
        out = rng.uniform(size=N) < 0.5
        tgt[b, out] = rng.uniform(-1.0, 1.0, (int(out.sum()), 3))
        feats[b, ~out] = base + 0.6 * rng.normal(size=(int((~out).sum()), C))
        seeds[b] = rng.permutation(np.flatnonzero(mask[b] & ~out))[:S]
        if b == 1:  # a masked inlier
            seeds[b, -1] = np.flatnonzero(~mask[b] & ~out)[0]
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    arrs = dict(feats=feats, src=src, tgt=tgt)
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrs.items()}
    t.update(mask=torch.from_numpy(mask), seeds=torch.from_numpy(seeds))
    t["knn"] = t_knn.seed_knn_plain(t["feats"], t["seeds"], K, t_knn.knn_bias(t["mask"],
                                                                               t["feats"]))
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_seed_hypotheses_plain_matches_jax(seed):
    """seed_trans and final_trans atol 1e-4 (sums in another order, the same
    f32 closed form), seed_fitness and final_labels exactly: the counts and
    labels of the same transforms."""
    t = stage_inputs(seed)
    sigma = 0.8
    jm = JaxPointDSC(in_dim=6, num_layers=2, num_channels=C, k=K, ratio=0.1)
    out_j = jm.apply({}, jnp.asarray(t["seeds"].numpy()), jnp.asarray(t["feats"].numpy()),
                     jnp.asarray(t["src"].numpy()), jnp.asarray(t["tgt"].numpy()),
                     jnp.full((1,), sigma, jnp.float32), jnp.asarray(t["mask"].numpy()), True,
                     method=JaxPointDSC._seed_transforms)
    out_t = t_score.seed_hypotheses_plain(t["feats"], t["seeds"], t["knn"], t["src"], t["tgt"],
                                          t["mask"], torch.full((1,), sigma), jm.sigma_d,
                                          jm.inlier_threshold, jm.num_iterations)
    seed_trans, fitness, final_trans, labels = (np.asarray(o) for o in out_j)
    np.testing.assert_allclose(out_t[0].numpy(), seed_trans, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out_t[1].numpy(), fitness)
    np.testing.assert_allclose(out_t[2].numpy(), final_trans, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out_t[3].numpy(), labels)
    assert fitness[1, -1] == -1.0 and float(fitness.max()) > 0.1


# ------------------------------------------------------------ seeds of a real forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_N = 1024


def real_forward_stage(snapshot, seed):
    """The seed stage's inputs from a fused eval forward of a trained
    snapshot on the CPU, batch 2 at N = 1024: sample 0 with its last 51
    points masked, sample 1 with only its first 36 valid, so that some NMS
    seeds are masked and have fewer than k = 40 valid neighbours. Returns the
    port model, the stage's arguments (normed features, NMS seeds, their
    neighbours by the model's k-NN, src, tgt, mask, sigma) and which seeds are
    valid inliers."""
    model = load_pretrained(os.path.join(ROOT, "snapshot", f"PointDSC_{snapshot}_release"),
                            device="cpu")
    data = dict(scene_scale=50.0, noise=0.05) if snapshot == "SyntheticKITTI" else {}
    ds = SyntheticPairDataset(num_pairs=2, num_corr=REAL_N, inlier_ratio=0.2, seed=seed, **data)
    cp, src, tgt, labels = (torch.stack([torch.as_tensor(ds[i][key]) for i in range(2)])
                            for key in ("corr_pos", "src_keypts", "tgt_keypts", "gt_labels"))
    mask = torch.ones((2, REAL_N), dtype=torch.bool)
    mask[0, REAL_N - 51:] = False
    mask[1, 36:] = False
    out = model(cp, src, tgt, mask=mask, fused=True)
    feats, seeds = out.normed_features, out.seeds
    knn = seed_knn_sorted(feats, seeds, model.k, mask)  # the model's, as N < 4096
    inlier = torch.gather(labels.bool() & mask, 1, seeds)
    return model, (feats, seeds, knn, src, tgt, mask, model.sigma.detach()), inlier


@pytest.mark.parametrize("snapshot,seed", [("Synthetic", 0), ("Synthetic", 1),
                                           ("SyntheticKITTI", 0)])
def test_seed_trans_of_real_seeds_against_f64(snapshot, seed):
    """Every NMS seed of a real forward (outliers, masked seeds and seeds with
    fewer than k valid neighbours among them) through the port's plain
    hypotheses and JAX's ``_seed_transforms`` (both f32) against the f64
    plain version: rotation and translation within each seed's tolerance
    from ``seed_trans_reference`` (atol 1e-4, scaled by the seed's Horn
    conditioning; translations by 1 + |c_s|)."""
    model, (feats, seeds, knn, src, tgt, mask, sigma), inlier = real_forward_stage(snapshot,
                                                                                   seed)
    k = model.k
    valid_nb = torch.gather(mask[:, None, :].expand(-1, seeds.shape[1], -1), 2, knn).sum(-1)
    assert (~inlier).sum() > 50 and (~torch.gather(mask, 1, seeds)).any()
    assert int(valid_nb.min()) < k
    ref, tol_rot, tol_trans = t_score.seed_trans_reference(
        feats, knn, src, tgt, mask, sigma, model.sigma_d, model.num_iterations)
    assert float(tol_rot.median()) == 1e-4
    port = t_score.seed_hypotheses(feats, seeds, knn, src, tgt, mask, sigma, model.sigma_d,
                                   model.inlier_threshold, model.num_iterations)[0]
    jm = JaxPointDSC(num_channels=model.num_channels, k=k, sigma_d=model.sigma_d,
                     inlier_threshold=model.inlier_threshold,
                     num_iterations=model.num_iterations)
    jax_trans = jm.apply({}, *(jnp.asarray(x.numpy()) for x in (seeds, feats, src, tgt, sigma,
                                                                mask)), True,
                         method=JaxPointDSC._seed_transforms)[0]
    for got in (port, torch.from_numpy(np.array(jax_trans))):
        err = (got.double() - ref).abs()
        assert bool(torch.all(err[..., :3, :3].amax((-1, -2)) <= tol_rot))
        assert bool(torch.all(err[..., :3, 3].amax(-1) <= tol_trans))


def test_seed_knn_sorted_matches_jax_outside_its_kernel_gate():
    """The model's k-NN below N = 4096 (``ops/knn.py::seed_knn_sorted``)
    against the JAX model's there (its distances, the seed and invalid
    points at 1e9, ``exact_topk``), exactly: sample 0 with 24 invalid
    points, sample 1 with only 10 valid, where the seed itself and invalid
    points fill the k = 16 list."""
    from pointdsc_tpu.ops.knn import exact_topk

    t = stage_inputs(3)
    mask = t["mask"].clone()
    mask[1, 10:] = False
    feats, seeds = t["feats"], t["seeds"]
    got = seed_knn_sorted(feats, seeds, K, mask)
    f, sd, m = (jnp.asarray(x.numpy()) for x in (feats, seeds, mask))
    seed_feats = jnp.take_along_axis(f, sd[:, :, None], axis=1)
    dist = 2.0 - 2.0 * jnp.einsum("bsc,bnc->bsn", seed_feats, f)
    dist = jnp.where(jnp.arange(N)[None, None, :] == sd[:, :, None], 1e9, dist)
    dist = jnp.where(m[:, None, :], dist, 1e9)
    want = np.asarray(exact_topk(-dist, K))
    np.testing.assert_array_equal(got.numpy(), want)
    # sample 1: the 10 valid points, then the 1e9 tier by index (a valid seed itself among it)
    assert torch.equal(torch.sort(got[1], dim=-1).values, torch.arange(K).expand(S, K))


# ------------------------------------------------------------ padded widths

def _attention(seed, c=C, n=96):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, n, c), generator=gen) for _ in range(3))
    src, tgt = (torch.rand((B, n, 3), generator=gen) for _ in range(2))
    mask = torch.ones((B, n), dtype=torch.bool)
    mask[1, n - 8:] = False
    return q, k, v, src, tgt, mask


def _fake_launch(plain):
    """A launch replaced by the plain version on the padded operands the
    wrapper hands it, with the width it passes (the scale constants')."""
    def launch(*args):
        *operands, c = args
        return plain(*operands, c=c)
    return launch


@pytest.mark.parametrize("offset", [False, True])
def test_cached_attention_wrapper_pads_exactly(offset, monkeypatch):
    """The card path of ``fused_sc_attention_cached`` at C = 32 (bf16
    operands padded to 128, the result sliced back), its launch replaced by
    the plain version on what it was handed: equal within 1e-6 to the plain
    version on the unpadded bf16 operands."""
    q, k, v, src, tgt, mask = _attention(0)
    cache = t_att.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    bias = t_att.key_bias(mask, B, q.shape[1], q.device)
    plain = t_att.sc_attention_cached_offset_plain if offset else t_att.sc_attention_cached_plain
    name = "_launch_sc_attention_offset" if offset else "_launch_sc_attention"
    seen = []

    def launch(*args):
        seen.append(args[0].shape[-1])
        return _fake_launch(plain)(*args)

    monkeypatch.setattr(t_att, name, launch)
    monkeypatch.setattr(t_att, "on_cuda", lambda x: True)
    out = t_att.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                          offset_softmax=offset)
    ref = plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), cache, bias)
    assert seen == [_check.C_KERNEL] and out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


def test_no_cache_attention_wrapper_pads_exactly(monkeypatch):
    q, k, v, src, tgt, mask = _attention(1)
    geom = t_att.pack_geometry(src, tgt, mask)

    def launch(q_, k_, v_, geom_, sigma_d, c):
        assert q_.shape[-1] == _check.C_KERNEL
        return t_att.sc_attention_nocache_plain(q_, k_, v_, geom_, sigma_d, c=c)

    monkeypatch.setattr(t_att, "_launch_sc_attention_nocache", launch)
    monkeypatch.setattr(t_att, "on_cuda", lambda x: True)
    out = t_att.fused_sc_attention(q, k, v, src, tgt, 0.1, mask=mask)
    ref = t_att.sc_attention_nocache_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), geom, 0.1)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


def test_trainable_attention_padding_is_exact():
    """The forward's out and LSE and the three gradients of the trainable
    attention on operands padded to 128 (with 1/sqrt(32)), sliced back,
    against the unpadded plain version; the padded gradient channels are
    zeros."""
    q, k, v, src, tgt, mask = _attention(2)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    geom = t_att.pack_geometry(src, tgt, mask)
    qp, kp, vp, dp = (_check.pad_channels(x) for x in (q, k, v, d_out))
    out, lse = t_att.sc_attention_forward_plain(q, k, v, geom, 0.1)
    out_p, lse_p = t_att.sc_attention_forward_plain(qp, kp, vp, geom, 0.1, c=C)
    torch.testing.assert_close(_check.unpad_channels(out_p, C), out, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=0)
    dvec = torch.sum(d_out * out, dim=-1)
    grads = t_att.sc_attention_backward_plain(q, k, v, geom, lse, dvec, d_out, 0.1)
    grads_p = t_att.sc_attention_backward_plain(qp, kp, vp, geom, lse, dvec, dp, 0.1, c=C)
    for g, gp in zip(grads, grads_p):
        torch.testing.assert_close(_check.unpad_channels(gp, C), g, atol=1e-6, rtol=0)
        assert not bool(gp[..., C:].any())


def _layer(seed, c=C, n=128):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def bn(ch):
        return (1.0 + rnd(ch, scale=0.1), rnd(ch, scale=0.1), rnd(ch, scale=0.1),
                1.0 + rnd(ch, scale=0.1).abs())

    w = c ** -0.5
    pcn = (rnd(c, c, scale=w), rnd(c, scale=0.1), bn(c))
    nl = (rnd(c, c, scale=w), rnd(c, scale=0.1), rnd(c, c, scale=w), rnd(c, scale=0.1),
          rnd(c, c, scale=w), rnd(c, scale=0.1), rnd(c // 2, c, scale=w), rnd(c // 2, scale=0.1),
          bn(c // 2), rnd(c // 2, c // 2, scale=w), rnd(c // 2, scale=0.1), bn(c // 2),
          rnd(c, c // 2, scale=w), rnd(c, scale=0.1))
    src, tgt = rnd(1, n, 3), rnd(1, n, 3)
    mask = torch.ones((1, n), dtype=torch.bool)
    mask[:, n - 8:] = False
    cache = t_att.build_compat_cache_int8(src, tgt, 0.5, mask=mask)
    return rnd(1, n, c), t_el.fold_layer(pcn, nl), cache, t_att.key_bias(mask, 1, n, src.device)


@pytest.mark.parametrize("part", ["one_launch", "pcn_qkv", "attn_mlp"])
def test_encoder_layer_padding_is_exact(part):
    """The encoder-layer kernels' functions on x and the ten folded arrays
    padded as the card path pads them (``pad_layer_weights``: q, k, v in
    their own thirds, the message MLP's C/2 to 64), with the layer's own
    1/sqrt(C), against the unpadded plain versions: the real channels within
    1e-6, the padded ones zero."""
    x, w, cache, kbias = _layer(4)
    wp = t_el.pad_layer_weights(w, C)
    assert [tuple(a.shape) for a in wp] == [tuple(a.shape) for a in _layer(4, c=128)[1]]
    xp = _check.pad_channels(x)
    if part == "one_launch":
        got = t_el.fused_layer_plain(xp, cache, kbias, wp, c=C)
        want = (t_el.fused_layer_plain(x, cache, kbias, w),)
        got = (got,)
    elif part == "pcn_qkv":
        got = t_el.pcn_qkv_plain(xp, wp, c=C)
        want = t_el.pcn_qkv_plain(x, w)
    else:
        h, q, k, v, kscale = t_el.pcn_qkv_plain(x, w)
        got = (t_el.attn_mlp_residual_plain(kscale, *(_check.pad_channels(a) for a in (q, k, v)),
                                            cache, kbias, _check.pad_channels(h), wp, c=C),)
        want = (t_el.attn_mlp_residual_plain(kscale, q, k, v, cache, kbias, h, w),)
    for g, r in zip(got, want):
        if g.ndim == 3:
            assert not bool(g[..., C:].float().any())
            g = _check.unpad_channels(g, C)
        torch.testing.assert_close(g.float(), r.float(), atol=1e-6, rtol=0)


def test_sm_loss_padding_is_exact():
    gen = torch.Generator().manual_seed(5)
    f = torch.nn.functional.normalize(torch.randn((B, 96, C), generator=gen), dim=-1)
    mask = torch.ones((B, 96), dtype=torch.bool)
    strips = t_sm.pack_labels((torch.rand((B, 96), generator=gen) < 0.4).float(), mask)
    scalars = torch.tensor([[0.9, 0.5, 0.5, 0.0]] * B)
    fp = _check.pad_channels(f)
    for a, b in zip(t_sm.sm_loss_sums_plain(fp, strips, scalars),
                    t_sm.sm_loss_sums_plain(f, strips, scalars)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    (df_p, ds_p), (df, ds) = (t_sm.sm_loss_grads_plain(x, strips, scalars) for x in (fp, f))
    torch.testing.assert_close(_check.unpad_channels(df_p, C), df, atol=1e-6, rtol=0)
    torch.testing.assert_close(ds_p, ds, atol=1e-6, rtol=0)
    assert not bool(df_p[..., C:].any())


def test_seed_knn_padding_is_exact():
    t = stage_inputs(2)
    bias = t_knn.knn_bias(t["mask"], t["feats"])
    got = t_knn.seed_knn_plain(_check.pad_channels(t["feats"]), t["seeds"], K, bias)
    assert torch.equal(got, t_knn.seed_knn_plain(t["feats"], t["seeds"], K, bias))


def test_widths_above_the_kernels_raise():
    """Every width from 1 up is taken (padded to the next multiple of 128);
    only C < 1 raises."""
    for c in (1, 128, 129, 256, 300):
        _check.check_width(c, "x")
        assert _check.padded_width(c) == 128 * -(-c // 128)
    assert tuple(_check.pad_channels(torch.ones(2, 129)).shape) == (2, 256)
    with pytest.raises(ValueError, match="C >= 1"):
        _check.check_width(0, "the attention kernels")


# ------------------------------------------------------------ the fused model at C = 32

@pytest.mark.parametrize("masked", [False, True])
def test_fused_model_at_c32_matches_jax(masked):
    """tests/test_fused_model.py's configuration (2 layers, C = 32, k = 16,
    ratio 0.1; 256 points, or 200 padded to 256) through the port's fused
    forward (the plain versions, here at the padded kernels' width's model)
    against JAX's fused forward: final_trans atol 1e-3, labels > 0.99."""
    rng = np.random.default_rng(0)
    jm = JaxPointDSC(in_dim=6, num_layers=2, num_channels=32, k=16, ratio=0.1)
    n_real = 200 if masked else 256
    cp, src, tgt, _, _ = make_synthetic_pair(rng, n=n_real, inlier_ratio=0.6)
    arrs = [np.concatenate([a, np.zeros((256 - n_real,) + a.shape[1:], a.dtype)])[None]
            for a in (cp, src, tgt)]
    mask = (np.arange(256) < n_real)[None]
    variables = jm.init(jax.random.key(0), *(jnp.asarray(a) for a in arrs),
                        mask=jnp.asarray(mask))
    out_j = jm.apply(variables, *(jnp.asarray(a) for a in arrs), mask=jnp.asarray(mask),
                     testing=True, fused_attention=True)
    tm = PointDSC(in_dim=6, num_layers=2, num_channels=32, k=16, ratio=0.1, device="cpu")
    tm.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                       strict=True)
    out_t = tm(*(torch.from_numpy(a) for a in arrs), mask=torch.from_numpy(mask), fused=True)
    np.testing.assert_allclose(out_t.final_trans.numpy(), np.asarray(out_j.final_trans),
                               atol=1e-3)
    assert (out_t.final_labels.numpy() == np.asarray(out_j.final_labels)).mean() > 0.99


# ------------------------------------------------------------ the gate

@pytest.mark.parametrize("needs_grad", [False, True])
def test_hypothesis_gate_predicate(needs_grad):
    for fused in (False, True):
        for testing in (False, True):
            want = fused and testing and not needs_grad
            assert t_model.use_hypothesis_kernel(fused, testing, needs_grad) == want


def test_forward_takes_any_k_on_the_cpu(monkeypatch):
    """Above the hypotheses kernel's 128 threads (on the card a thread then
    owns several neighbour rows) the CPU's fused forward reaches the seed
    stage's wrapper, whose plain version takes any k, and agrees with the
    dense path (final_trans atol 1e-3, labels > 0.99)."""
    calls = []

    def spy(*args):
        calls.append(args[2].shape[-1])
        return t_score.seed_hypotheses(*args)

    monkeypatch.setattr(t_model, "seed_hypotheses", spy)
    model = PointDSC(num_layers=1, num_channels=C, k=130, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    cp, src, tgt, _, _ = make_synthetic_pair(np.random.default_rng(2), n=N)
    args = [torch.from_numpy(a)[None] for a in (cp, src, tgt)]
    out = model(*args, fused=True)
    dense = model(*args, fused=False)
    assert calls == [130]
    torch.testing.assert_close(out.final_trans, dense.final_trans, atol=1e-3, rtol=0)
    assert (out.final_labels == dense.final_labels).float().mean() > 0.99


@pytest.mark.parametrize("grad", [False, True])
def test_forward_reaches_the_seed_stage_wrapper_without_a_gradient(grad, monkeypatch):
    """A fused eval forward on the CPU calls ``seed_hypotheses`` exactly when
    no gradient is asked for, and both routes give the same result; with a
    gradient, seed_trans carries one back to sigma."""
    calls = []

    def spy(*args):
        calls.append(None)
        return t_score.seed_hypotheses(*args)

    monkeypatch.setattr(t_model, "seed_hypotheses", spy)
    model = PointDSC(num_layers=1, num_channels=C, k=K, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    cp, src, tgt, _, _ = make_synthetic_pair(np.random.default_rng(1), n=N)
    args = [torch.from_numpy(a)[None] for a in (cp, src, tgt)]
    with torch.enable_grad() if grad else torch.no_grad():
        out = model(*args, fused=True)
        if grad:
            assert out.seed_trans.requires_grad
            out.seed_trans.sum().backward()
            assert model.sigma.grad is not None
    assert len(calls) == int(not grad)
    with torch.no_grad():
        ref = model(*args, fused=True)
    torch.testing.assert_close(out.final_trans.detach(), ref.final_trans, atol=0, rtol=0)
    assert torch.equal(out.seed_fitness, ref.seed_fitness)


# ------------------------------------------------------------ any number of seeds

@pytest.mark.parametrize("k", [9000, 12000])
def test_seed_select_beyond_the_shared_memory_sort(k):
    """The seed select's plain version (the card's above 8192 seeds sorts in
    a workspace) takes any k: against ``jax.lax.top_k`` on keys with many
    +-0.0 ties (suppressed points), exactly."""
    rng = np.random.default_rng(k)
    vals = rng.normal(size=(2, 12288)).astype(np.float32)
    vals[:, rng.uniform(size=12288) < 0.5] = 0.0
    vals[0, ::7] = -0.0
    keys = _total_order_key(torch.from_numpy(vals))
    got = t_nms.nms_select(keys, k)
    _, want = jax.lax.top_k(jnp.asarray(vals), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert t_nms.select_workspace_size(k) == 2 * 16384
    assert t_nms.select_workspace_size(8192) == 0
