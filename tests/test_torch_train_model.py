"""The port's training forward against the JAX model's at a small size (2
layers, C = 32, N = 128 with 16 padded points, batch 2): outputs, BatchNorm
statistics and every parameter's gradient, dense and fused, from the same
weights (JAX's initialisation, converted) and the same float32 inputs made
with numpy from a seed. JAX's fused path runs its Pallas kernels in interpret
mode; the port's runs the kernels' plain versions (CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.kernels.sm_loss import fused_spectral_matching_loss as j_fused_sm
from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu.train import losses as j_losses
from pointdsc_tpu_torch import PointDSC
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.kernels.sm_loss import fused_spectral_matching_loss as t_fused_sm
from pointdsc_tpu_torch.train import losses as t_losses
from tests.test_model import make_synthetic_pair

KW = dict(in_dim=6, num_layers=2, num_channels=32, k=12, ratio=0.2)
N, VALID = 128, 112


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread is the fastest on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed=51, pad_fill=0.0):
    """Two pairs of 112 correspondences padded to 128 (``pad_fill`` in the
    padded rows' coordinates), with labels and the ground-truth transform."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("corr_pos", "src_keypts", "tgt_keypts", "gt_trans", "gt_labels")}
    for _ in range(2):
        cp, src, tgt, gt, lab = make_synthetic_pair(rng, n=VALID, inlier_ratio=0.6)
        pad = N - VALID
        for key, a in (("corr_pos", cp), ("src_keypts", src), ("tgt_keypts", tgt)):
            out[key].append(np.concatenate([a, np.full((pad, a.shape[1]), pad_fill, np.float32)]))
        out["gt_labels"].append(np.concatenate([lab, np.zeros(pad, np.float32)]))
        out["gt_trans"].append(gt)
    batch = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    batch["mask"] = np.tile(np.arange(N) < VALID, (2, 1))
    return batch


@pytest.fixture(scope="module")
def setup():
    """(JAX model, its initial variables as numpy, the converted state dict)."""
    jm = JaxPointDSC(**KW)
    b = make_batch()
    variables = jm.init(jax.random.key(0), jnp.asarray(b["corr_pos"]),
                        jnp.asarray(b["src_keypts"]), jnp.asarray(b["tgt_keypts"]))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    # away from the initial values, so that a swapped or ignored statistic shows
    rng = np.random.default_rng(3)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * np.abs(rng.normal(size=a.shape))).astype(np.float32),
        variables["batch_stats"])
    variables["params"]["sigma"] = np.asarray([0.8], np.float32)
    return jm, variables, from_flax_variables(variables)


def port_model(state, **flags):
    model = PointDSC(**KW, device="cpu", **flags)
    model.load_state_dict(state, strict=True)
    return model


def jax_loss(jm, variables, batch, fused, weight_transformation=0.0):
    """The Trainer's loss on the JAX side: (loss, (new batch_stats, output))."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jb["corr_pos"], jb["src_keypts"], jb["tgt_keypts"], mask=jb["mask"],
                            train=True, fused_attention=fused, skip_M=fused,
                            mutable=["batch_stats"])
        cl = j_losses.classification_loss(out.final_labels, jb["gt_labels"], jb["mask"])
        if fused:
            sm = j_fused_sm(out.normed_features, out.sigma, jb["gt_labels"], jb["mask"], True)
        else:
            sm = j_losses.spectral_matching_loss(out.M, jb["gt_labels"], jb["mask"])
        loss = cl + sm
        if weight_transformation:
            tl = j_losses.transformation_loss(out.final_trans, jb["gt_trans"], jb["src_keypts"],
                                              jb["tgt_keypts"], out.final_labels, jb["mask"])
            loss = loss + weight_transformation * tl.loss
        return loss, (upd["batch_stats"], out)

    return jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])


def port_loss(model, batch, fused, weight_transformation=0.0):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["corr_pos"], tb["src_keypts"], tb["tgt_keypts"], mask=tb["mask"],
                testing=False, fused=fused, skip_M=fused)
    cl = t_losses.classification_loss(out.final_labels, tb["gt_labels"], tb["mask"])
    if fused:
        sm = t_fused_sm(out.normed_features, out.sigma, tb["gt_labels"], tb["mask"], True)
    else:
        sm = t_losses.spectral_matching_loss(out.M, tb["gt_labels"], tb["mask"])
    loss = cl + sm
    if weight_transformation:
        tl = t_losses.transformation_loss(out.final_trans, tb["gt_trans"], tb["src_keypts"],
                                          tb["tgt_keypts"], out.final_labels, tb["mask"])
        loss = loss + weight_transformation * tl.loss
    return loss, out


def assert_grads_match(model, grads_j, atol):
    ref = from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    names = dict(model.named_parameters())
    assert set(ref) == set(names)
    for name, p in names.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=atol, err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_training_forward_and_gradients_match_jax(setup, fused):
    """Same path on both sides. Loss rtol 1e-5, features atol 1e-5, running
    statistics atol 1e-6, every parameter's gradient atol 1e-4 dense and 2e-3
    fused (the JAX suite's fused-against-dense bound: the two fused attentions
    sum keys in another order behind a compat factor that divides by 0.01)."""
    jm, variables, state = setup
    batch = make_batch()
    (loss_j, (stats_j, out_j)), grads_j = jax_loss(jm, variables, batch, fused)

    model = port_model(state).train()
    loss, out = port_loss(model, batch, fused)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    valid = batch["mask"]
    np.testing.assert_allclose(out.normed_features.detach().numpy()[valid],
                               np.asarray(out_j.normed_features)[valid], atol=1e-5)
    assert (out.M is None) == fused and out.final_labels is out.confidence
    seeds_j = jax.lax.top_k(jnp.where(jnp.asarray(valid), out_j.confidence, -jnp.inf),
                            out.seeds.shape[1])[1]
    np.testing.assert_array_equal(out.seeds.numpy(), np.asarray(seeds_j))
    after = from_flax_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, stats_j)})
    for name, value in after.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), value.numpy(), atol=1e-6,
                                   err_msg=name)
        assert not torch.equal(model.state_dict()[name], state[name]), name
    assert_grads_match(model, grads_j, atol=2e-3 if fused else 1e-4)


def test_transformation_loss_gradients_match_jax(setup):
    """With ``weight_transformation > 0`` gradients run through the top-k
    seeds' NSM: power iteration, weighted Procrustes and the closed-form 4x4
    eigenvector (Newton steps and an adjugate). Dense path, atol 1e-3 on
    gradients that reach ~1: the chain is f32 on both sides."""
    jm, variables, state = setup
    batch = make_batch()
    (loss_j, _), grads_j = jax_loss(jm, variables, batch, False, weight_transformation=1.0)
    model = port_model(state).train()
    loss, _ = port_loss(model, batch, False, weight_transformation=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4)
    assert_grads_match(model, grads_j, atol=1e-3)


def test_trainer_eval_forward_matches_jax(setup):
    """``train=False, testing=False, fused``: the int8 cache and the
    whole-layer offset kernels (plain versions here) with the plain confidence
    head and top-k seeds, and no post-refinement. Features and logits atol
    1e-3 (the cache may differ by one int8 step at a few entries), seeds as
    sets (a near tie of two logits may swap), final_trans atol 1e-3."""
    jm, variables, state = setup
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out_j = jm.apply(variables, jb["corr_pos"], jb["src_keypts"], jb["tgt_keypts"],
                     mask=jb["mask"], train=False, fused_attention=True, skip_M=True)
    model = port_model(state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(tb["corr_pos"], tb["src_keypts"], tb["tgt_keypts"], mask=tb["mask"],
                    testing=False, fused=True, skip_M=True)
    valid = batch["mask"]
    np.testing.assert_allclose(out.normed_features.numpy()[valid],
                               np.asarray(out_j.normed_features)[valid], atol=1e-3)
    np.testing.assert_allclose(out.final_labels.numpy()[valid],
                               np.asarray(out_j.final_labels)[valid], atol=1e-3)
    assert out.M is None and float(out.sigma.detach()) == pytest.approx(0.8)
    seeds_j = np.asarray(jax.lax.top_k(jnp.where(jb["mask"], out_j.confidence, -jnp.inf),
                                       out.seeds.shape[1])[1])
    for b in range(2):
        overlap = len(set(out.seeds[b].tolist()) & set(seeds_j[b].tolist()))
        assert overlap >= out.seeds.shape[1] - 1
    np.testing.assert_allclose(out.final_trans.numpy(), np.asarray(out_j.final_trans), atol=1e-3)


def test_eval_step_after_train_step_sees_new_weights(setup):
    """The whole-layer kernels' folded weights are cached on tensor versions:
    after an optimizer step (parameters) and a training forward (running
    statistics) the next fused eval forward must use the new values, i.e.
    equal a fresh model's that loads the same state dict."""
    _, _, state = setup
    batch = make_batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def eval_forward(m):
        with torch.no_grad():
            return m(tb["corr_pos"], tb["src_keypts"], tb["tgt_keypts"], mask=tb["mask"],
                     testing=False, fused=True, skip_M=True).normed_features

    model = port_model(state)
    before = eval_forward(model)  # fills the fold cache
    assert model._fold_cache
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model.train()
    loss, _ = port_loss(model, batch, True)
    loss.backward()
    opt.step()
    model.eval()
    after = eval_forward(model)
    fresh = port_model(model.state_dict())
    assert torch.equal(after, eval_forward(fresh))
    assert float((after - before).abs().max()) > 1e-3

    # running statistics alone (no optimizer step) invalidate it too
    model.train()
    with torch.no_grad():
        port_loss(model, batch, True)
    model.eval()
    assert torch.equal(eval_forward(model), eval_forward(port_model(model.state_dict())))


@pytest.mark.parametrize("fused", [False, True])
def test_remat_gives_the_same_step(setup, fused):
    """Checkpointed encoder layers: the same loss and gradients (the layers
    are recomputed from the same inputs, so bit for bit), and the running
    statistics advance once, not twice."""
    _, _, state = setup
    batch = make_batch()
    plain, remat = port_model(state).train(), port_model(state, remat=True).train()
    results = []
    for model in (plain, remat):
        loss, _ = port_loss(model, batch, fused)
        loss.backward()
        results.append(loss.detach())
    assert torch.equal(*results)
    for (name, p), (_, r) in zip(plain.named_parameters(), remat.named_parameters()):
        assert torch.equal(p.grad, r.grad), name
    for name, value in plain.state_dict().items():
        assert torch.equal(value, remat.state_dict()[name]), name


@pytest.mark.parametrize("fused", [False, True])
def test_padded_rows_drop_out(setup, fused):
    """Whatever the padded rows hold, the valid rows' features, the losses,
    the seeds and the BatchNorm statistics are the same: padding is biased out
    as a key and masked out of statistics, losses and seeds."""
    _, _, state = setup
    results = []
    for fill in (0.0, 7.5):
        model = port_model(state).train()
        batch = make_batch(pad_fill=fill)
        loss, out = port_loss(model, batch, fused)
        loss.backward()
        results.append((loss.detach(), out.normed_features.detach()[:, :VALID], out.seeds,
                        out.final_trans.detach(), model.state_dict(),
                        {n: p.grad for n, p in model.named_parameters()}))
    a, b = results
    # the padded rows' own corr_pos enter layer0 only through their own rows
    torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(a[1], b[1], atol=1e-6, rtol=1e-6)
    assert torch.equal(a[2], b[2]) and int(a[2].max()) < VALID
    torch.testing.assert_close(a[3], b[3], atol=1e-5, rtol=1e-5)
    for name in a[4]:
        torch.testing.assert_close(a[4][name], b[4][name], atol=1e-6, rtol=1e-6, msg=name)
    for name in a[5]:
        torch.testing.assert_close(a[5][name], b[5][name], atol=1e-5, rtol=1e-4, msg=name)


def test_model_modes_and_flags(setup):
    """A new model and ``load_state_dict`` leave eval mode; training mode
    builds no cache; ``fused_cache_compat=False`` gives the cached eval
    forward's features within the int8 cache's resolution."""
    _, _, state = setup
    model = port_model(state)
    assert not model.training
    batch = make_batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    args = (tb["corr_pos"], tb["src_keypts"], tb["tgt_keypts"])
    with torch.no_grad():
        cached = model(*args, mask=tb["mask"]).normed_features
        nocache = port_model(state, fused_cache_compat=False)(*args, mask=tb["mask"])
    np.testing.assert_allclose(nocache.normed_features.numpy()[batch["mask"]],
                               cached.numpy()[batch["mask"]], atol=2e-3)
    assert nocache.M is None and nocache.final_labels.shape == (2, N)
    model.train()
    model._fold_cache.clear()
    out = model(*args, mask=tb["mask"], testing=False, fused=True)
    assert not model._fold_cache and out.M is not None and out.M.requires_grad


def test_half_precision_training_step(setup):
    """``half_precision`` in training mode: bf16 Dense products, BatchNorm
    statistics in f32, the trainable attention on f32 copies of q, k, v.
    Gradients are finite for every parameter, the loss lies within 2% of the
    f32 model's and the running statistics within 5e-2 (bf16 keeps ~3
    digits per product)."""
    _, _, state = setup
    batch = make_batch()
    results = {}
    for half in (False, True):
        model = port_model(state, half_precision=half).train()
        loss, out = port_loss(model, batch, True)
        loss.backward()
        assert out.normed_features.dtype == torch.float32
        for name, p in model.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
            assert p.grad.dtype == torch.float32
        results[half] = (float(loss.detach()), model.state_dict())
    assert results[True][0] == pytest.approx(results[False][0], rel=2e-2)
    for name, value in results[False][1].items():
        if "running_" in name:
            assert value.dtype == torch.float32
            torch.testing.assert_close(results[True][1][name], value, atol=5e-2, rtol=5e-2)
