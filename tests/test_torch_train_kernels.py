"""The port's training kernels' plain versions and ``autograd.Function``s
against the JAX package's custom-VJP kernels (Pallas interpret mode, 128
blocks) on the same float32 inputs made with numpy from a seed; the losses and
the training-mode BatchNorm against their JAX counterparts; and
``torch.autograd.gradcheck`` of both plain forward/backward pairs in float64.
On the CPU a wrapper runs its plain version; the CUDA kernels themselves are
held to the same plain versions in ``tests/test_torch_port_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu.kernels import sm_loss as j_sm
from pointdsc_tpu.models.blocks import MaskedBatchNorm as JaxMaskedBatchNorm
from pointdsc_tpu.ops import compatibility as j_compat
from pointdsc_tpu.ops import nms as j_nms
from pointdsc_tpu.train import losses as j_losses
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.kernels import sm_loss as t_sm
from pointdsc_tpu_torch.models.blocks import MaskedBatchNorm
from pointdsc_tpu_torch.ops import compatibility as t_compat
from pointdsc_tpu_torch.ops import nms as t_nms
from pointdsc_tpu_torch.train import losses as t_losses


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread is the fastest on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(a):
    return np.asarray(a, np.float32)


def attention_inputs(rng, n, c, masked):
    q, k, v, w = (f32(rng.normal(size=(2, n, c))) for _ in range(4))
    src = f32(rng.uniform(-1, 1, (2, n, 3)))
    tgt = src + f32(rng.normal(size=(2, n, 3))) * 0.05
    mask = np.ones((2, n), bool)
    if masked:
        mask[:, n - n // 5:] = False
        w = w * mask[..., None]  # padded rows carry no loss, as in the model
    return q, k, v, w, src, tgt, mask


def jax_trainable(q, k, v, src, tgt, mask, masked):
    """The JAX entry as the model calls it: vmapped over the batch."""
    geom = jax.vmap(j_att.pack_geometry)(jnp.asarray(src), jnp.asarray(tgt),
                                         jnp.asarray(mask) if masked else None) \
        if masked else jax.vmap(lambda s, t: j_att.pack_geometry(s, t, None))(
            jnp.asarray(src), jnp.asarray(tgt))
    return jax.vmap(lambda qq, kk, vv, gg: j_att.sc_attention_trainable(
        qq, kk, vv, gg, 0.1, 128, 128, True))(q, k, v, geom)


@pytest.mark.parametrize("masked", [False, True])
def test_sc_attention_trainable_matches_jax(rng, masked):
    """N = 256, C = 32. out atol 2e-5 and gradients atol 5e-4, the JAX
    suite's own bounds against its dense reference: both sides sum 256 keys in
    f32 in another order, and the compat factor divides a difference of two
    distances by 0.01."""
    check_trainable_against_jax(rng, 256, 32, masked)


def test_sc_attention_trainable_matches_jax_at_card_width(rng):
    """The card kernels' width, C = 128, at N = 512 with the last fifth
    masked: the function the C = 128 backward kernels are held to on the card
    (``tests/test_torch_port_cuda.py``), at the C = 32 test's bounds."""
    check_trainable_against_jax(rng, 512, 128, True)


def check_trainable_against_jax(rng, n, c, masked):
    """The port's trainable attention (its plain versions on the CPU) against
    JAX's custom-VJP kernels in interpret mode: out atol 2e-5, the gradients
    of sum(out * w) atol 5e-4; a padded key gets no gradient."""
    q, k, v, w, src, tgt, mask = attention_inputs(rng, n, c, masked)
    wj = jnp.asarray(w)

    out_j, grads_j = jax.value_and_grad(
        lambda qq, kk, vv: jnp.sum(jax_trainable(qq, kk, vv, src, tgt, mask, masked) * wj),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = np.asarray(jax_trainable(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), src, tgt,
                                   mask, masked))

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    geom = t_att.pack_geometry(torch.from_numpy(src), torch.from_numpy(tgt),
                               torch.from_numpy(mask) if masked else None)
    out = t_att.sc_attention_trainable(*leaves, geom, 0.1)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5)
    torch.sum(out * torch.from_numpy(w)).backward()
    for leaf, gj, name in zip(leaves, grads_j, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj), atol=5e-4,
                                   err_msg=f"d{name}")
    if masked:  # a padded key's P is exactly 0
        pad = n - n // 5
        assert float(leaves[1].grad[:, pad:].abs().max()) == 0.0
        assert float(leaves[2].grad[:, pad:].abs().max()) == 0.0


@pytest.mark.parametrize("bs,n,dq_ms,dkv_ms",
                         [(16, 1024, 0.20083, 0.26493), (1, 12288, 1.80743, 2.38437)])
def test_train_attention_bounds(bs, n, dq_ms, dkv_ms):
    """The backward kernels' bounds, from the one count of their work that
    chip_smoke.py phase 12 and tools/time_attention.py both read, are the
    values PERF.md gives them (f32 operations at 67 TFLOP/s; the bytes take
    a few hundredths of that)."""
    from pointdsc_tpu_torch.tools import time_attention

    work = t_att.train_attention_work(bs, n)
    for name, want in (("dq", dq_ms), ("dkv", dkv_ms)):
        got, by = time_attention.bound_ms(*work[name])
        assert by == "operations" and abs(got - want) < 5e-6, (name, got, by)


@pytest.mark.parametrize("bs,n,fwd_ms", [(16, 1024, 0.13647), (1, 12288, 1.22824)])
def test_train_attention_forward_bound(bs, n, fwd_ms):
    """The forward kernel's bound (4 N^2 C operations a sample, the compat
    entry and the softmax of every pair, at 67 TFLOP/s), from the count that
    chip_smoke.py phase 12 and tools/time_attention.py read, is the value
    PERF.md gives it."""
    from pointdsc_tpu_torch.tools import time_attention

    got, by = time_attention.bound_ms(*t_att.train_attention_work(bs, n)["forward"])
    assert by == "operations" and abs(got - fwd_ms) < 5e-6, (got, by)


def test_geometry_strip_and_no_cache_forward_match_jax(rng):
    """``pack_geometry`` is the JAX strip; the eval attention without a cache
    is JAX's ``fused_sc_attention`` in interpret mode (atol 2e-5), and the
    trainable forward's out on the same inputs."""
    q, k, v, _, src, tgt, mask = attention_inputs(rng, 256, 32, True)
    st, tt, mt = (torch.from_numpy(a) for a in (src, tgt, mask))
    geom_j = jax.vmap(j_att.pack_geometry)(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    geom = t_att.pack_geometry(st, tt, mt)
    np.testing.assert_allclose(geom.numpy(), np.asarray(geom_j), atol=1e-6)
    ref = j_att.fused_sc_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(src), jnp.asarray(tgt), 0.1,
                                   mask=jnp.asarray(mask), block_q=128, block_k=128,
                                   interpret=True)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out = t_att.fused_sc_attention(qt, kt, vt, st, tt, 0.1, mask=mt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert torch.equal(out, t_att.sc_attention_forward(qt, kt, vt, geom, 0.1)[0])


def test_sc_attention_gradcheck_float64():
    """The plain forward/backward pair (what the Function runs on a CPU
    tensor) against finite differences in float64, with padded keys."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 48, 8), generator=gen, dtype=torch.float64).requires_grad_()
               for _ in range(3))
    src = torch.rand((2, 48, 3), generator=gen)
    tgt = src + 0.05 * torch.randn((2, 48, 3), generator=gen)
    mask = torch.arange(48)[None].expand(2, -1) < 40
    geom = t_att.pack_geometry(src, tgt, mask).double()
    assert torch.autograd.gradcheck(
        lambda a, b, c: t_att.sc_attention_trainable(a, b, c, geom, 0.1), (q, k, v), atol=1e-6)


def sm_inputs(rng, b=2, n=256, c=32, pad=0):
    f = rng.normal(size=(b, n, c)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    gt = (rng.random((b, n)) < 0.3).astype(np.float32)
    mask = np.ones((b, n), bool)
    if pad:
        mask[:, n - pad:] = False
        gt *= mask
    return f, gt, mask


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("pad", [0, 57])
@pytest.mark.parametrize("sigma", [1.07, 0.4])
def test_fused_sm_loss_matches_jax(rng, balanced, pad, sigma):
    """Value rtol 1e-5, dF atol 1e-6, dsigma rtol 1e-4 against the JAX kernel
    in interpret mode (the bounds of its own test against the dense chain);
    sigma = 0.4 drives many entries into the clamp, so the gate is live."""
    f, gt, mask = sm_inputs(rng, pad=pad)
    loss_j, (df_j, ds_j) = jax.value_and_grad(
        lambda ff, ss: j_sm.fused_spectral_matching_loss(ff, ss, jnp.asarray(gt),
                                                         jnp.asarray(mask), balanced, True),
        argnums=(0, 1))(jnp.asarray(f), jnp.asarray(sigma, jnp.float32))

    ft = torch.from_numpy(f.copy()).requires_grad_()
    st = torch.tensor([sigma], dtype=torch.float32, requires_grad=True)
    loss = t_sm.fused_spectral_matching_loss(ft, st, torch.from_numpy(gt),
                                             torch.from_numpy(mask), balanced)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(df_j), atol=1e-6)
    np.testing.assert_allclose(float(st.grad), float(ds_j), rtol=1e-4)
    assert st.grad.shape == (1,)

    # and the dense chain of the port itself, through autograd
    fd = torch.from_numpy(f.copy()).requires_grad_()
    sd = torch.tensor([sigma], dtype=torch.float32, requires_grad=True)
    dense = t_losses.spectral_matching_loss(
        t_compat.feature_similarity(fd, sd, mask=torch.from_numpy(mask)), torch.from_numpy(gt),
        torch.from_numpy(mask), balanced=balanced)
    dense.backward()
    np.testing.assert_allclose(float(loss.detach()), float(dense.detach()), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), fd.grad.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(st.grad), float(sd.grad), rtol=1e-4)


@pytest.mark.parametrize("balanced", [True, False])
def test_sm_loss_gradcheck_float64(balanced):
    gen = torch.Generator().manual_seed(1)
    f = torch.randn((2, 40, 8), generator=gen, dtype=torch.float64)
    f = (f / f.norm(dim=-1, keepdim=True)).requires_grad_()
    sigma = torch.tensor([0.8], dtype=torch.float64, requires_grad=True)
    gt = (torch.rand((2, 40), generator=gen) < 0.3).double()
    mask = torch.arange(40)[None].expand(2, -1) < 33
    assert torch.autograd.gradcheck(
        lambda a, s: t_sm.fused_spectral_matching_loss(a, s, gt, mask, balanced), (f, sigma),
        atol=1e-7)


def test_sm_loss_takes_any_n(rng):
    """N = 1000 has no tiling the TPU kernel accepts, so JAX takes its dense
    chain there; the port's entry takes every N (the CUDA kernel guards its
    tail tiles) and gives the same loss."""
    f, gt, mask = sm_inputs(rng, b=1, n=1000, c=16, pad=24)
    ref = j_sm.fused_spectral_matching_loss(jnp.asarray(f), jnp.asarray(1.1, jnp.float32),
                                            jnp.asarray(gt), jnp.asarray(mask), True, True)
    got = t_sm.fused_spectral_matching_loss(torch.from_numpy(f), torch.tensor([1.1]),
                                            torch.from_numpy(gt), torch.from_numpy(mask), True)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("bs,n,sums_ms,grads_ms",
                         [(16, 1024, 0.03377, 0.13422), (1, 12288, 0.30422, 1.20796)])
def test_sm_loss_bounds(bs, n, sums_ms, grads_ms):
    """The SM-loss kernels' bounds, from the one count of their work that
    chip_smoke.py phase 12 and tools/time_attention.py read, are the values
    PERF.md gives them: 2 C + 14 f32 operations for each unordered pair of
    the sums (every term is symmetric in (i, j), the diagonal's is 0), 4 C +
    24 for each ordered pair of the gradients, at 67 TFLOP/s."""
    from pointdsc_tpu_torch.tools import time_attention

    work = t_sm.sm_loss_work(bs, n)
    for name, want in (("sums", sums_ms), ("grads", grads_ms)):
        got, by = time_attention.bound_ms(*work[name])
        assert by == "operations" and abs(got - want) < 5e-6, (name, got, by)


@pytest.mark.parametrize("window", [0.0, 0.02])
def test_grads_gate_slack_bounds_a_flipped_gate(window):
    """Flipping the gate of every valid off-diagonal pair whose u lies within
    ``window`` of 0 or 1 moves the plain dF by no more than
    ``grads_gate_slack``, entry by entry; with no pair there the slack is 0.
    (float64, so that the flips are the only change.)"""
    gen = torch.Generator().manual_seed(5)
    f = torch.nn.functional.normalize(torch.randn((2, 90, 16), generator=gen,
                                                  dtype=torch.float64), dim=-1)
    gt = (torch.rand((2, 90), generator=gen) < 0.3).double()
    mask = torch.arange(90)[None].expand(2, -1) < 80
    strips = t_sm.pack_labels(gt, mask)
    wp, wn = t_sm.balance_weights(strips, True)
    scalars = torch.stack([torch.full_like(wp, 0.7), wp, wn, torch.zeros_like(wp)], dim=-1)
    _, u, g, pairs, coef = t_sm._grad_terms(f, strips, scalars)
    gate = ((u > 0.0) & (u < 1.0)).double() * pairs
    near = ((u.abs() <= window) | ((u - 1.0).abs() <= window)).double() * pairs
    flipped = coef * torch.einsum("bnm,bmc->bnc", g * (gate + near - 2 * gate * near), f)
    df, _ = t_sm.sm_loss_grads_plain(f, strips, scalars)
    slack = t_sm.grads_gate_slack(f, strips, scalars, window)
    assert bool(((flipped - df).abs() <= slack + 1e-15).all())
    if window:
        assert float(near.sum()) > 0 and float(slack.max()) > 0.0
    else:
        assert float(slack.max()) == 0.0


PLAN_NS = [1, 31, 33, 63, 65, 1000, 1024, 12288]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("n", PLAN_NS)
def test_sums_plan_covers_the_triangle(n, batch):
    """The sums kernel's items count every unordered pair of points exactly
    twice. An item's step (owned block o, tile t) covers the 32-row tiles
    2 o and 2 o + 1 against tile t, at the kernel's weight: 1 in o's diagonal
    block (t // 2 == o), whose pairs it walks in both orders, else 2. So the
    weights W[a, t] of the ordered tile pairs must give W + W^T = 2
    everywhere: a pair of distinct tiles once at weight 2 or both orders at
    weight 1, a tile against itself once at weight 1, no tile twice."""
    items = t_sm.sums_plan(batch, n, 132)
    tiles = -(-n // t_sm.TILE)
    w = np.zeros((tiles, tiles))
    for o, first, count in items:
        assert 1 <= count <= t_sm.MAX_RUN and 2 * o <= first and first + count <= tiles
        for t in range(first, first + count):
            for a in (2 * o, 2 * o + 1):
                if a < tiles:
                    w[a, t] += 1.0 if t // 2 == o else 2.0
    np.testing.assert_array_equal(w + w.T, np.full((tiles, tiles), 2.0))
    assert [it[2] for it in items] == sorted((it[2] for it in items), reverse=True)


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("n", PLAN_NS)
def test_grads_plan_covers_each_walk(n, batch):
    """The gradients kernel's runs cover each row block's ceil(n / 32) tiles
    exactly once, in one or two consecutive runs, none empty; the walk is
    split where one block an SM leaves the last wave part-empty (1 x 12288 on
    132 SMs: 192 blocks) and not where it fills it (16 x 1024: 256)."""
    splits, run = t_sm.grads_plan(batch, n, 132)
    tiles = -(-n // t_sm.TILE)
    covered = [t for s in range(splits) for t in range(s * run, min(tiles, (s + 1) * run))]
    assert splits in (1, 2) and covered == list(range(tiles))
    assert all(s * run < tiles for s in range(splits))
    if (batch, n) == (1, 12288):
        assert splits == 2
    if (batch, n) == (16, 1024):
        assert splits == 1


# ---------------------------------------------------------------- losses

def loss_inputs(rng, b=3, n=200):
    logits = f32(rng.normal(size=(b, n)) * 2.0)
    gt = (rng.random((b, n)) < 0.35).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[:, n - 30:] = False
    return logits, gt, mask


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_classification_loss_and_metrics_match_jax(rng, balanced, masked):
    """atol 1e-6: the same elementwise f32 formulas and one sum."""
    logits, gt, mask = loss_inputs(rng)
    mj, mt = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    ref = j_losses.classification_loss(jnp.asarray(logits), jnp.asarray(gt), mj, balanced)
    got = t_losses.classification_loss(torch.from_numpy(logits), torch.from_numpy(gt), mt,
                                       balanced)
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6)
    ref_m = j_losses.classification_metrics(jnp.asarray(logits), jnp.asarray(gt), mj)
    got_m = t_losses.classification_metrics(torch.from_numpy(logits), torch.from_numpy(gt), mt)
    assert got_m.keys() == ref_m.keys()
    for key in ref_m:
        np.testing.assert_allclose(float(got_m[key]), float(ref_m[key]), atol=1e-6, err_msg=key)


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_spectral_matching_loss_matches_jax(rng, balanced, masked):
    """``feature_similarity`` atol 1e-6 and the dense loss rtol 1e-6; the
    diagonal stays in the denominators."""
    f, gt, mask = sm_inputs(rng, n=128, pad=20 if masked else 0)
    mj, mt = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    M_j = j_compat.feature_similarity(jnp.asarray(f), jnp.asarray([0.9], jnp.float32), mask=mj)
    M_t = t_compat.feature_similarity(torch.from_numpy(f), torch.tensor([0.9]), mask=mt)
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), atol=1e-6)
    ref = j_losses.spectral_matching_loss(M_j, jnp.asarray(gt), mj, balanced=balanced)
    got = t_losses.spectral_matching_loss(M_t, torch.from_numpy(gt), mt, balanced=balanced)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_transformation_loss_matches_jax(rng):
    """Every field rtol 1e-5, but the angle atol 1e-3 degrees: at ~2 degrees
    the arccos turns one f32 rounding of the trace (6e-8) into ~1e-4 degrees.
    One sample has no predicted inlier and contributes no loss."""
    b, n = 3, 150
    src = f32(rng.uniform(-1, 1, (b, n, 3)))
    trans, gt_trans = np.tile(np.eye(4, dtype=np.float32), (2, b, 1, 1))
    for i in range(b):
        rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rot *= np.sign(np.linalg.det(rot))
        gt_trans[i, :3, :3], gt_trans[i, :3, 3] = rot, rng.normal(size=3) * 0.3
        # the estimate: the truth turned a little about z
        a = 0.02 * (i + 1)
        dz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        trans[i, :3, :3], trans[i, :3, 3] = dz @ rot, gt_trans[i, :3, 3] + 0.01 * i
    tgt = f32(np.einsum("bij,bnj->bni", gt_trans[:, :3, :3], src) + gt_trans[:, None, :3, 3])
    probs = f32(rng.normal(size=(b, n)))
    probs[1] = -1.0
    mask = np.ones((b, n), bool)
    mask[:, n - 20:] = False
    ref = j_losses.transformation_loss(*(jnp.asarray(a) for a in (trans, gt_trans, src, tgt,
                                                                   probs, mask)))
    got = t_losses.transformation_loss(*(torch.from_numpy(a) for a in (trans, gt_trans, src, tgt,
                                                                       probs, mask)))
    for name in ("loss", "recall", "re", "te", "rmse"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-3 if name == "re" else 1e-5, err_msg=name)
    assert float(got.loss) > 0


def test_pick_seeds_topk_matches_jax(rng):
    """Equal scores fall as ``jax.lax.top_k`` puts them; padded points last."""
    scores = f32(np.round(rng.normal(size=(2, 300)), 1))  # many exact ties
    mask = np.ones((2, 300), bool)
    mask[1, 250:] = False
    for m in (None, mask):
        ref = j_nms.pick_seeds_topk(jnp.asarray(scores), 40, None if m is None else jnp.asarray(m))
        got = t_nms.pick_seeds_topk(torch.from_numpy(scores), 40,
                                    None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_training_matches_jax(rng, masked):
    """Two training steps then eval: outputs atol = rtol = 1e-5, running
    statistics atol 1e-6 + rtol 1e-5 (f32 sums of 150 terms in another order).
    The statistics take the valid entries only and the running
    variance is the biased one (``nn.BatchNorm1d`` would store the unbiased)."""
    x1, x2 = (f32(rng.normal(size=(3, 50, 16)) * 2.0 + 1.0) for _ in range(2))
    mask = np.ones((3, 50), bool)
    mask[:, 35:] = False
    x1[:, 35:] = 100.0  # padding must not reach the statistics
    mj, mt = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    scale, bias = f32(rng.normal(size=16)), f32(rng.normal(size=16))

    jbn = JaxMaskedBatchNorm()
    variables = jbn.init(jax.random.key(0), jnp.asarray(x1))
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    tbn = MaskedBatchNorm(16)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    tbn.train()
    for x in (x1, x2):
        yj, upd = jbn.apply(variables, jnp.asarray(x), mask=mj, train=True,
                            mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        yt = tbn(torch.from_numpy(x), mt)
        valid = mask if masked else np.ones_like(mask)
        np.testing.assert_allclose(yt.detach().numpy()[valid], np.asarray(yj)[valid], atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]), atol=1e-6, rtol=1e-5)
    if masked:
        biased = x2[mask].var(axis=0)  # numpy's default is the biased variance
        after_first = (tbn.running_var.numpy() - 0.1 * biased) / 0.9
        assert np.all(after_first < 10.0), "the padding's 100s reached the statistics"

    before = tbn.running_mean.clone()
    tbn(torch.from_numpy(x2), mt, update_stats=False)
    assert torch.equal(tbn.running_mean, before)
    tbn.eval()
    yj = jbn.apply(variables, jnp.asarray(x2), mask=mj, train=False)
    np.testing.assert_allclose(tbn(torch.from_numpy(x2), mt).detach().numpy(), np.asarray(yj),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(tbn.running_mean, before)
