"""The port's VoxelFCGF training (``pointdsc_tpu_torch/descriptors/
fcgf_train.py``) against the JAX package's on the CPU.

* ``hardest_contrastive_loss``, with and without a mask: the loss and its
  four metrics within 1e-6 (float32 on both sides), and its gradients;
* one train step at the tiny width (encoder (8, 16, 32, 32), decoder
  (16, 16, 8, 8), 16 channels) on a ``train_fcgf.make_pair`` pair at a 32^3
  grid and 10 cm voxels (some matched indices fall outside the grid and are
  masked; both packages clamp them alike), against
  ``make_fcgf_train_step`` with ``optax.adam(1e-3)`` in float64. The port in
  float64 (measured: loss 1.3e-10, gradients 1.1e-8 of up to 0.28, running
  statistics 4.9e-8, parameters after Adam 1.7e-7): the loss within 1e-9,
  every gradient within 1e-7, the statistics within 1e-7, the parameters
  within 1e-6. The port in float32, the card's path (measured 3.4e-7,
  3.5e-5, 1.8e-7): the loss within 1e-5, the gradients within 1e-4, the
  statistics within 1e-6. Its parameters after Adam are not compared: the
  gradient of a convolution bias that feeds a training-mode BatchNorm is
  zero in exact arithmetic and ~1e-9 of rounding in float32, which Adam's
  first step (g / (|g| + 1e-8)) turns into an update of up to ~lr / 10 of
  either sign.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pointdsc_tpu.descriptors import fcgf as j_fcgf  # noqa: E402
from pointdsc_tpu.descriptors import fcgf_train as j_train  # noqa: E402
from pointdsc_tpu_torch.compat.fcgf_weights import (  # noqa: E402
    from_flax_fcgf_variables,
    to_flax_fcgf_variables,
)
from pointdsc_tpu_torch.descriptors import fcgf as t_fcgf  # noqa: E402
from pointdsc_tpu_torch.descriptors import fcgf_train as t_train  # noqa: E402
from pointdsc_tpu_torch.tools.train_fcgf import make_pair  # noqa: E402

TINY = dict(out_dim=16, enc_channels=(8, 16, 32, 32), dec_channels=(16, 16, 8, 8))
LR = 1e-3


def descriptor_pairs(seed, n=96, c=16):
    """Unit descriptors f0 and f1 = f0 + noise (renormalised), and a mask
    with a quarter of the rows off."""
    gen = np.random.default_rng(seed)
    f0 = gen.normal(size=(n, c))
    f1 = f0 + 0.6 * gen.normal(size=(n, c))
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    return f0.astype(np.float32), f1.astype(np.float32), gen.random(n) > 0.25


@pytest.mark.parametrize("masked", [False, True])
def test_hardest_contrastive_loss(masked):
    f0, f1, mask = descriptor_pairs(0)
    mask = mask if masked else None
    ref_loss, ref = j_train.hardest_contrastive_loss(
        jnp.asarray(f0), jnp.asarray(f1), mask=None if mask is None else jnp.asarray(mask))
    t0 = torch.from_numpy(f0).requires_grad_()
    t1 = torch.from_numpy(f1).requires_grad_()
    loss, metrics = t_train.hardest_contrastive_loss(
        t0, t1, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), atol=1e-6)
    for key in ("pos_loss", "neg_loss", "pos_dist", "neg_dist"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(ref[key]), atol=1e-6,
                                   err_msg=key)
    assert float(ref["neg_loss"]) > 0.01  # the hardest negatives enter the loss
    loss.backward()
    g0, g1 = jax.grad(lambda a, b: j_train.hardest_contrastive_loss(
        a, b, mask=None if mask is None else jnp.asarray(mask))[0], argnums=(0, 1))(
            jnp.asarray(f0), jnp.asarray(f1))
    np.testing.assert_allclose(t0.grad.numpy(), np.asarray(g0), atol=1e-6)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), atol=1e-6)


@pytest.fixture(scope="module")
def step_case():
    """The pair, JAX's init with the output bias drawn from a seed (float64)
    and JAX's step: (inputs, variables, gradients, new params, new batch
    stats, loss)."""
    rng = np.random.default_rng(3)
    occ0, occ1, i0, i1, ok, _ = make_pair(rng, 0.1, 32)
    assert 0 < (~ok).sum() < len(ok)
    model = j_fcgf.VoxelFCGF(**TINY)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 32, 1)))
    # the output layer's bias off zero: at JAX's init a voxel whose last
    # ResBlock output is all zero gives a zero descriptor, whose
    # normalisation has slope 1e6 and whose distances to every unit
    # descriptor tie at 1 up to rounding (trained weights have no such
    # voxel). The other biases stay 0: large ones would make E[x^2] - E[x]^2
    # of the sparse grids' BatchNorms cancel to ~1e-6 even in float64.
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    variables["params"]["Conv_0"]["bias"] = np.random.default_rng(4).normal(0.0, 0.1, 16)
    occ0_j, occ1_j = (jnp.asarray(o.transpose(1, 2, 3, 0)[None], jnp.float64)
                      for o in (occ0, occ1))
    args = (occ0_j, occ1_j, jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(ok))

    def loss_fn(params):
        g0, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              occ0_j, train=True, mutable=["batch_stats"])
        g1, _ = model.apply({"params": params, "batch_stats": upd["batch_stats"]}, occ1_j,
                            train=True, mutable=["batch_stats"])
        f0 = g0[0][args[2][:, 0], args[2][:, 1], args[2][:, 2]]
        f1 = g1[0][args[3][:, 0], args[3][:, 1], args[3][:, 2]]
        return j_train.hardest_contrastive_loss(f0, f1, mask=args[4])[0]

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    tx = optax.adam(LR)
    step = j_train.make_fcgf_train_step(model, tx)
    params, _, stats, metrics = step(variables["params"], tx.init(variables["params"]),
                                     variables["batch_stats"], *args)
    return ((occ0, occ1, i0, i1, ok), variables, grads, params, stats, float(metrics["loss"]))


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_train_step(step_case, dtype):
    (occ0, occ1, i0, i1, ok), variables, grads, params, stats, loss = step_case
    model = t_fcgf.VoxelFCGF(**TINY, device="cpu").to(dtype)
    model.load_state_dict(from_flax_fcgf_variables(variables))
    step = t_train.make_fcgf_train_step(model, torch.optim.Adam(model.parameters(), lr=LR))
    metrics = step(torch.from_numpy(occ0)[None].to(dtype), torch.from_numpy(occ1)[None].to(dtype),
                   torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(ok))
    exact = dtype == torch.float64
    tol = (dict(loss=1e-9, grads=1e-7, stats=1e-7, params=1e-6) if exact
           else dict(loss=1e-5, grads=1e-4, stats=1e-6))
    np.testing.assert_allclose(float(metrics["loss"]), loss, atol=tol["loss"])
    assert model.training

    # the gradients, read from .grad in the flax layout
    grad_state = {k: p.grad for k, p in model.named_parameters()}
    got = flat(to_flax_fcgf_variables(grad_state)["params"])
    ref = flat(grads)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], atol=tol["grads"], err_msg=key)
    after = to_flax_fcgf_variables(model.state_dict())
    got, ref = flat(after["batch_stats"]), flat(stats)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], atol=tol["stats"], err_msg=key)
    if exact:
        got, ref = flat(after["params"]), flat(params)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], atol=tol["params"], err_msg=key)
