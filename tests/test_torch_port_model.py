"""The port's eval forward against the JAX model at full width (12 layers,
C = 128, k = 40, the Synthetic snapshot's weights), on the same float32
inputs: the dense path against JAX's dense path, and the fused path (the
kernels' plain versions on the CPU) against JAX's
``fused_attention=True, offset_softmax=False`` path; plus the golden file
that the card's run is held to.

Run as a script, this file rewrites a golden file from the JAX package's
dense path (~1 min on the CPU): the one of seed 0, or with
``--seed 1`` the one of the pairs on which the snapshot stays inside the
offset softmax's regime, which the card's default-configuration run is held
to:

    python -m tests.test_torch_port_model [--seed 1]
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.data import SyntheticPairDataset
from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu.ops.knn import pairwise_dists_exact
from pointdsc_tpu.ops.nms import pick_seeds_nms
from pointdsc_tpu.train.config import Config
from pointdsc_tpu.train.trainer import load_model_weights
from pointdsc_tpu_torch import PointDSC, load_pretrained, register
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.data import SyntheticPairDataset as PortSyntheticPairDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAP = os.path.join(ROOT, "snapshot", "PointDSC_Synthetic_release")
GOLDEN = os.path.join(ROOT, "pointdsc_tpu_torch", "testdata", "golden_n5120.npz")
N = 512


@pytest.fixture(autouse=True)
def no_grad():
    """Grad mode is the caller's: these tests run the eval forward without."""
    with torch.no_grad():
        yield


def inputs(masked):
    """One synthetic pair at N = 512; masked: 480 real points padded to 512."""
    ex = SyntheticPairDataset(num_pairs=1, num_corr=480 if masked else N, seed=7)[0]
    arrs = [ex[k] for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    if masked:
        arrs = [np.concatenate([a, np.zeros((N - 480, a.shape[1]), a.dtype)]) for a in arrs]
    mask = (np.arange(N) < 480)[None] if masked else None
    return [np.asarray(a, np.float32)[None] for a in arrs], mask


@pytest.fixture(scope="module")
def models():
    jm = JaxPointDSC(in_dim=6, num_layers=12, num_channels=128, k=40, offset_softmax=False)
    (cp, src, tgt), _ = inputs(False)
    variables = load_model_weights(jm, os.path.join(SNAP, "models", "model_best.pkl"),
                                   (jnp.asarray(cp), jnp.asarray(src), jnp.asarray(tgt)))
    tm = PointDSC(device="cpu", offset_softmax=False)
    tm.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                       strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(models, masked, fused):
    """Dense: features 1e-4, seeds identical, final_trans 1e-4, labels equal.
    Fused: features and final_trans 1e-3 (the int8 cache may differ by 1 at
    a few entries; JAX's fused refinement centres the clouds first), label
    agreement > 0.99."""
    jm, variables, tm = models
    arrs, mask = inputs(masked)
    mj = None if mask is None else jnp.asarray(mask)
    oj = jm.apply(variables, *(jnp.asarray(a) for a in arrs), mask=mj, testing=True,
                  fused_attention=fused)
    ot = tm(*(torch.from_numpy(a) for a in arrs),
            mask=None if mask is None else torch.from_numpy(mask), fused=fused)
    tol = 1e-3 if fused else 1e-4
    np.testing.assert_allclose(ot.normed_features.numpy(), np.asarray(oj.normed_features),
                               atol=tol)
    np.testing.assert_allclose(ot.final_trans.numpy(), np.asarray(oj.final_trans), atol=tol)
    labels_j = np.asarray(oj.final_labels)
    agree = (ot.final_labels.numpy() == labels_j).mean()
    if fused:
        assert agree > 0.99
    else:
        assert agree == 1.0
        seeds_j = pick_seeds_nms(pairwise_dists_exact(jnp.asarray(arrs[1])), oj.confidence,
                                 jm.nms_radius, max(1, int(N * jm.ratio)), mask=mj)
        np.testing.assert_array_equal(ot.seeds.numpy(), np.asarray(seeds_j))


def test_kitti_refinement_threshold(models):
    """inlier_threshold != 0.10 switches the post-refinement threshold to
    1.2, as in JAX (models/pointdsc.py:465): the snapshot's weights with the
    KITTI thresholds, on the pair scaled to tens of metres."""
    _, variables, tm = models
    kw = dict(inlier_threshold=0.6, sigma_d=1.2, nms_radius=0.6)
    jm = JaxPointDSC(in_dim=6, num_layers=12, num_channels=128, k=40, **kw)
    (cp, src, tgt), _ = inputs(False)
    src, tgt = src * 20.0, tgt * 20.0
    oj = jm.apply(variables, *(jnp.asarray(a) for a in (cp, src, tgt)), testing=True)
    km = PointDSC(**kw, device="cpu")
    km.load_state_dict(tm.state_dict(), strict=True)
    ot = km(*(torch.from_numpy(a) for a in (cp, src, tgt)), fused=False)
    np.testing.assert_allclose(ot.final_trans.numpy(), np.asarray(oj.final_trans), atol=1e-4)


def test_random_init_from_generator():
    """Random weights come from the caller's generator: same seed, same model."""
    a = PointDSC(num_layers=2, num_channels=32, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    b = PointDSC(num_layers=2, num_channels=32, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.encoder.layer0.weight.abs().sum() > 0


def test_golden_file():
    """The port's fused forward (plain kernel versions here) reproduces the
    JAX dense path's golden results for the card's smoke pairs."""
    gold = np.load(GOLDEN)
    n = int(gold["n"])
    model = load_pretrained(SNAP, device="cpu")
    ds = PortSyntheticPairDataset(num_pairs=3, num_corr=n, inlier_ratio=float(gold["inlier_ratio"]),
                                  seed=int(gold["seed"]))
    for i in range(3):
        ex = ds[i]
        out = register(ex["corr_pos"], ex["src_keypts"], ex["tgt_keypts"], model=model,
                       device="cpu")
        np.testing.assert_allclose(out.final_trans[0].numpy(), gold["final_trans"][i], atol=1e-3)
        assert ((out.final_labels[0].numpy() > 0.5) == gold["final_labels"][i]).mean() > 0.99


def test_port_dataset_matches_jax_dataset():
    a = SyntheticPairDataset(num_pairs=2, num_corr=300, seed=5)[1]
    b = PortSyntheticPairDataset(num_pairs=2, num_corr=300, seed=5)[1]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def write_golden(path=GOLDEN, pairs=3, n=5120, seed=0, inlier_ratio=0.4):
    """The JAX dense path's final_trans, seeds and final_labels for the smoke
    pairs (SyntheticPairDataset seed 0, inlier ratio 0.4, N = 5120) at full
    width with the Synthetic snapshot. The inputs are regenerated from the
    seed, so they are not stored."""
    jax.config.update("jax_platforms", "cpu")
    cfg = Config.load(os.path.join(SNAP, "config.json"))
    model = JaxPointDSC(
        in_dim=cfg.in_dim, num_layers=cfg.num_layers, num_channels=cfg.num_channels,
        num_iterations=cfg.num_iterations, ratio=cfg.ratio, sigma_d=cfg.sigma_d, k=cfg.k,
        inlier_threshold=cfg.inlier_threshold, nms_radius=cfg.nms_radius,
    )
    ds = SyntheticPairDataset(num_pairs=pairs, num_corr=n, inlier_ratio=inlier_ratio, seed=seed)
    trans, seeds, labels = [], [], []
    variables = None
    for i in range(pairs):
        ex = ds[i]
        cp, src, tgt = (jnp.asarray(ex[k])[None] for k in ("corr_pos", "src_keypts", "tgt_keypts"))
        if variables is None:
            variables = load_model_weights(
                model, os.path.join(SNAP, "models", "model_best.pkl"), (cp, src, tgt))
        out = model.apply(variables, cp, src, tgt, testing=True)
        seeds.append(np.asarray(pick_seeds_nms(
            pairwise_dists_exact(src), out.confidence, cfg.nms_radius,
            max(1, int(n * cfg.ratio))))[0])
        trans.append(np.asarray(out.final_trans, np.float32)[0])
        labels.append(np.asarray(out.final_labels)[0] > 0.5)
    np.savez_compressed(path, final_trans=np.stack(trans), seeds=np.stack(seeds).astype(np.int32),
                        final_labels=np.stack(labels), n=n, seed=seed, inlier_ratio=inlier_ratio)
    print(f"wrote {path}")


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--seed", "1"]:
        write_golden(path=GOLDEN.replace(".npz", "_seed1.npz"), seed=1)
    else:
        write_golden()
