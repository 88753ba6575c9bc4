"""The port's OANet (``pointdsc_tpu_torch/models/oanet.py``), its
``ContextNorm`` (``models/blocks.py``), the reference OANet importer
(``compat/weights.py::from_torch_oanet_state_dict``) and the
``approx_knn`` flag of ``PointDSC`` against the JAX package on the CPU.

* ``ContextNorm`` in both variance conventions, masked and unmasked:
  within 1e-5;
* ``OANet`` (in_dim 6, 6 layers, C = 32, 8 clusters, n = 128, a quarter of
  the second sample padded) with JAX's init carried over by
  ``from_flax_variables`` (running statistics drawn from a seed), in eval
  and training mode: logits and transforms within 1e-4, training mode's
  running statistics within 1e-5;
* padded logits at -1e9; finite, non-zero gradients;
* ``from_torch_oanet_state_dict`` on a random state dict in the reference's
  layout: the same tree as JAX's, which the port's OANet loads strictly;
* ``approx_knn=True`` gives exactly the outputs of ``approx_knn=False``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pointdsc_tpu.compat.torch_weights import (  # noqa: E402
    from_torch_oanet_state_dict as j_from_torch_oanet,
)
from pointdsc_tpu.models import OANet as JaxOANet  # noqa: E402
from pointdsc_tpu.models.blocks import ContextNorm as JaxContextNorm  # noqa: E402
from pointdsc_tpu_torch import PointDSC  # noqa: E402
from pointdsc_tpu_torch.compat.weights import (  # noqa: E402
    from_flax_variables,
    from_torch_oanet_state_dict,
    to_flax_variables,
)
from pointdsc_tpu_torch.data import SyntheticPairDataset  # noqa: E402
from pointdsc_tpu_torch.models import OANet  # noqa: E402
from pointdsc_tpu_torch.models.blocks import ContextNorm  # noqa: E402

CFG = dict(in_dim=6, num_layers=6, num_channels=32, num_clusters=8)
N, PAD = 128, 32


@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_context_norm(unbiased, masked):
    gen = np.random.default_rng(0)
    x = (gen.normal(size=(2, 50, 7)) * 3.0 + 1.5).astype(np.float32)
    mask = np.arange(50)[None] < np.array([[50], [31]]) if masked else None
    ref = JaxContextNorm(unbiased=unbiased).apply(
        {}, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    out = ContextNorm(unbiased=unbiased)(torch.from_numpy(x),
                                         None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def batch():
    """Two samples of N correspondences (40% inliers); the second's last
    PAD padded with far-away points."""
    exs = [SyntheticPairDataset(num_pairs=2, num_corr=N, seed=3)[i] for i in range(2)]
    cp, src, tgt = (np.stack([e[k] for e in exs]).astype(np.float32)
                    for k in ("corr_pos", "src_keypts", "tgt_keypts"))
    mask = np.ones((2, N), bool)
    mask[1, N - PAD:] = False
    for a in (cp, src, tgt):
        a[1, N - PAD:] = 5.0
    return cp, src, tgt, mask


@pytest.fixture(scope="module")
def carried():
    """(JAX model, its init with running statistics drawn from a seed (numpy),
    the port's OANet with those weights, the batch)."""
    cp, src, tgt, mask = batch()
    model = JaxOANet(**CFG)
    variables = jax.jit(lambda k, a, b, c, m: model.init(k, a, b, c, mask=m))(
        jax.random.key(0), cp, src, tgt, mask)
    gen = np.random.default_rng(1)
    variables = {
        "params": jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.05 * gen.normal(size=a.shape)).astype(np.float32),
            variables["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda a: (0.3 * gen.normal(size=a.shape) if np.all(np.asarray(a) == 0)
                       else gen.uniform(0.5, 1.5, a.shape)).astype(np.float32),
            variables["batch_stats"])}
    port = OANet(**CFG, device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return model, variables, port, (cp, src, tgt, mask)


@pytest.mark.parametrize("train", [False, True])
def test_oanet_against_jax(carried, train):
    model, variables, port, (cp, src, tgt, mask) = carried
    port = OANet(**CFG, device="cpu")
    port.load_state_dict(from_flax_variables(variables))
    port.train(train)
    if train:
        ref, upd = jax.jit(lambda v: model.apply(v, cp, src, tgt, mask=mask, train=True,
                                                 mutable=["batch_stats"]))(variables)
    else:
        ref = jax.jit(lambda v: model.apply(v, cp, src, tgt, mask=mask))(variables)
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (cp, src, tgt, mask)))
    np.testing.assert_allclose(out["final_labels"].numpy(), np.asarray(ref["final_labels"]),
                               atol=1e-4)
    np.testing.assert_allclose(out["final_trans"].numpy(), np.asarray(ref["final_trans"]),
                               atol=1e-4)
    assert out["M"] is None
    if train:
        stats = to_flax_variables(port.state_dict())["batch_stats"]
        for path, value in jax.tree_util.tree_leaves_with_path(upd["batch_stats"]):
            got = stats
            for key in path:
                got = got[key.key]
            np.testing.assert_allclose(got, np.asarray(value), atol=1e-5, err_msg=str(path))


def test_mask_forces_padded_logits(carried):
    *_, port, (cp, src, tgt, mask) = carried
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (cp, src, tgt, mask)), testing=True)
    assert float(out["final_labels"][1, N - PAD:].max()) <= -1e8
    assert bool(torch.isfinite(out["final_trans"]).all())


def test_gradients_finite(carried):
    *_, port, (cp, src, tgt, mask) = carried
    model = OANet(**CFG, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    model.load_state_dict(port.state_dict())
    out = model(*(torch.from_numpy(a) for a in (cp, src, tgt, mask)))
    logits = out["final_labels"][torch.from_numpy(mask)]
    labels = torch.from_numpy(np.random.default_rng(2).random(logits.shape) < 0.4).float()
    torch.nn.functional.binary_cross_entropy_with_logits(logits, labels).backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert sum(float(g.abs().max() > 0) for g in grads) >= 0.9 * len(grads)


def reference_state_dict(c, k, in_dim, num_layers, seed=0):
    """A random state dict in the reference OANet's layout."""
    gen = np.random.default_rng(seed)
    sd = {}

    def conv(name, cin, cout):
        sd[f"{name}.weight"] = gen.normal(size=(cout, cin, 1))
        sd[f"{name}.bias"] = gen.normal(size=cout)

    def bn(name, f):
        sd[f"{name}.weight"] = gen.normal(size=f)
        sd[f"{name}.bias"] = gen.normal(size=f)
        sd[f"{name}.running_mean"] = gen.normal(size=f)
        sd[f"{name}.running_var"] = gen.uniform(0.5, 2.0, f)

    half = num_layers // 2
    for name, cin, layers in (("l1_1", in_dim, half), ("l1_2", 2 * c, half - 1)):
        conv(f"{name}.0", cin, c)
        for j in range(layers):
            conv(f"{name}.{1 + 4 * j}", c, c)
            bn(f"{name}.{3 + 4 * j}", c)
    for name in ("down1", "up1"):
        bn(f"{name}.conv.1", c)
        conv(f"{name}.conv.3", c, k)
    for i in range(half):
        bn(f"l2.{i}.conv1.1", c)
        conv(f"l2.{i}.conv1.3", c, c)
        bn(f"l2.{i}.conv2.0", k)
        conv(f"l2.{i}.conv2.2", k, k)
        bn(f"l2.{i}.conv3.2", c)
        conv(f"l2.{i}.conv3.4", c, c)
    conv("output", c, 1)
    return sd


def test_from_torch_oanet_state_dict():
    sd = reference_state_dict(32, 8, 6, 6)
    tree = from_torch_oanet_state_dict(sd, 6)
    ref = j_from_torch_oanet(sd, 6)
    got_leaves = jax.tree_util.tree_leaves_with_path(tree)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (_, a), (_, b) in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)
    OANet(**CFG, device="cpu").load_state_dict(from_flax_variables(tree), strict=True)
    with pytest.raises(KeyError):
        from_torch_oanet_state_dict({k: v for k, v in sd.items() if k != "output.bias"}, 6)


def test_approx_knn_flag_selects_exactly():
    """Both flags, the fused and the dense path on the CPU (the seed k-NN's
    plain version): the same outputs, bit for bit."""
    ex = SyntheticPairDataset(num_pairs=1, num_corr=256, seed=1)[0]
    args = [torch.as_tensor(ex[k])[None] for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    outs = {}
    for approx in (False, True):
        model = PointDSC(num_layers=2, num_channels=32, k=16, approx_knn=approx, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        assert model.approx_knn is approx
        with torch.no_grad():
            outs[approx] = [model(*args, fused=fused) for fused in (True, False)]
    for a, b in zip(outs[False], outs[True]):
        for x, y in zip(a, b):
            if x is not None:
                assert torch.equal(x, y)
