"""The port's VoxelFCGF descriptor network (``pointdsc_tpu_torch/descriptors/
fcgf.py``, ``compat/fcgf_weights.py``) against the JAX package's on the CPU.

A tiny network (encoder (8, 16, 32, 32), decoder (16, 16, 8, 8), 16 output
channels, a 32^3 grid) carries the weights of JAX's init with every bias,
BatchNorm affine and running statistic perturbed from a seed, so that each
leaf of the map matters. The reference is JAX's forward in float64: its own
float32 forward is up to 4.4e-5 from it on these weights, and its float32
batch statistics sum 32^3 voxels in one sequential order (E[x^2] - E[x]^2 off
by up to ~1e-3 of the variance, measured), so float32 against float32 would
test JAX's rounding, not the port. The port runs in float64 (the math:
atol 1e-9) and in float32 (the path the card runs: atol 1e-4 on the unit
features, 1e-5 on the running statistics):

* eval mode, and training mode with its advanced running statistics
  (momentum 0.9, the biased variance);
* ``extract_features`` and ``extract_features_tiled`` (grid 32, halo 4,
  three tiles): keypoints equal, features within 1e-4;
* the release checkpoint ``snapshot/fcgf_synth_release.pkl`` at full width
  on one 32^3 cloud against JAX's float32 forward: the occupied voxels'
  features within 1e-3;
* the weight map port -> flax -> port exactly, and the port's checkpoint
  file read by ``flax.serialization.from_bytes``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pointdsc_tpu.descriptors import fcgf as j_fcgf  # noqa: E402
from pointdsc_tpu_torch.compat import flax_msgpack  # noqa: E402
from pointdsc_tpu_torch.compat.fcgf_weights import (  # noqa: E402
    from_flax_fcgf_variables,
    save_fcgf_checkpoint,
    to_flax_fcgf_variables,
)
from pointdsc_tpu_torch.descriptors import fcgf as t_fcgf  # noqa: E402

TINY = dict(out_dim=16, enc_channels=(8, 16, 32, 32), dec_channels=(16, 16, 8, 8))
RELEASE = os.path.join(ROOT, "snapshot", "fcgf_synth_release.pkl")
GRID = 32


def perturbed(variables, seed=1):
    """JAX's init with biases, BatchNorm scales and running statistics moved
    off their defaults (numpy float32)."""
    gen = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * gen.normal(size=a.shape)).astype(np.float32), tree["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (0.2 * gen.normal(size=a.shape) if a.ndim and np.all(a == 0)
                   else gen.uniform(0.5, 1.5, a.shape)).astype(np.float32), tree["batch_stats"])
    return {"params": params, "batch_stats": stats}


def cloud(seed, n=600, extent=1.5):
    return np.random.default_rng(seed).uniform(0, extent, (n, 3))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, perturbed variables, port model in float32)."""
    model = j_fcgf.VoxelFCGF(**TINY)
    variables = perturbed(jax.jit(model.init)(jax.random.key(0),
                                              jnp.zeros((1, GRID, GRID, GRID, 1))))
    return model, variables, port_model(variables, torch.float32)


def channels_last(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().transpose(0, 2, 3, 4, 1)


def test_voxelize():
    """Occupancy, clipped indices and origin equal JAX's, with the origin
    from the cloud and given (points beyond the grid clamp to its border)."""
    pts = cloud(0, 800, 2.0)
    for origin in (None, np.array([0.3, -0.2, 0.1])):
        occ, idx, org = t_fcgf.voxelize(pts, 0.05, GRID, origin=origin)
        j_occ, j_idx, j_org = j_fcgf.voxelize(pts, 0.05, GRID, origin=origin)
        assert occ.shape == (1, GRID, GRID, GRID) and occ.dtype == np.float32
        np.testing.assert_array_equal(occ[0], j_occ[..., 0])
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_array_equal(org, j_org)
    assert (idx == GRID - 1).any()  # some points clamped


def as64(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)


def port_model(variables, dtype):
    port = t_fcgf.VoxelFCGF(**TINY, device="cpu").to(dtype)
    port.load_state_dict(from_flax_fcgf_variables(variables))
    return port


DTYPES = [(torch.float64, 1e-9, 1e-9), (torch.float32, 1e-4, 1e-5)]


@pytest.mark.parametrize("dtype,atol,stats_atol", DTYPES)
def test_eval_forward(tiny, dtype, atol, stats_atol):
    model, variables, _ = tiny
    port = port_model(variables, dtype)
    occ = t_fcgf.voxelize(cloud(1), 0.05, GRID)[0]
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        as64(variables), occ.transpose(1, 2, 3, 0)[None].astype(np.float64)))
    with torch.no_grad():
        out = channels_last(port(torch.from_numpy(occ)[None].to(dtype)))
    assert out.shape == (1, GRID, GRID, GRID, 16)
    np.testing.assert_allclose(out, ref, atol=atol)
    assert np.abs(np.linalg.norm(out, axis=-1) - 1.0).max() < 1e-4


@pytest.mark.parametrize("dtype,atol,stats_atol", DTYPES)
def test_train_forward_and_batch_stats(tiny, dtype, atol, stats_atol):
    """Two grids of a batch, training mode: the batch-normalised output and
    the advanced running statistics."""
    model, variables, _ = tiny
    port = port_model(variables, dtype).train()
    occ = np.stack([t_fcgf.voxelize(cloud(s, 1500), 0.05, GRID)[0] for s in (2, 3)])
    ref, upd = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
        as64(variables), occ.transpose(0, 2, 3, 4, 1).astype(np.float64))
    with torch.no_grad():
        out = channels_last(port(torch.from_numpy(occ).to(dtype)))
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol)
    stats = to_flax_fcgf_variables(port.state_dict())["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    assert len(leaves) == len(jax.tree_util.tree_leaves(stats))
    for path, value in leaves:
        got = stats
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(value), atol=stats_atol, err_msg=str(path))


def test_extract_features(tiny):
    model, variables, port = tiny
    pts = cloud(4)
    kp, feat = t_fcgf.extract_features(port, pts, 0.05, GRID)
    j_kp, j_feat = j_fcgf.extract_features(model, as64(variables), pts, 0.05, GRID)
    assert port.training is False and kp.dtype == np.float32 and feat.shape == (len(kp), 16)
    np.testing.assert_array_equal(kp, j_kp)
    np.testing.assert_allclose(feat, j_feat, atol=1e-4)


def test_extract_features_tiled(tiny):
    """A 5 x 2 x 1 m slab at 10 cm voxels: tiles of 24 interior voxels
    (2.4 m) in x, three of them, the last one a partial batch."""
    model, variables, port = tiny
    gen = np.random.default_rng(5)
    pts = gen.uniform(0, 1, (3000, 3)) * np.array([5.0, 2.0, 1.0])
    kp, feat = t_fcgf.extract_features_tiled(port, pts, 0.1, GRID, halo=4, tile_batch=2)
    j_kp, j_feat = j_fcgf.extract_features_tiled(model, as64(variables), pts, 0.1, GRID,
                                                 halo=4, tile_batch=2)
    np.testing.assert_array_equal(kp, j_kp)
    np.testing.assert_allclose(feat, j_feat, atol=1e-4)
    assert len(np.unique(kp, axis=0)) == len(kp)
    assert len(np.unique(np.floor(kp[:, 0] / 2.4))) == 3


def test_release_checkpoint_full_width():
    """``load_fcgf`` on the release file at the default widths (15,843,840
    parameters) against JAX's forward with the same tree, on the occupied
    voxels of one 32^3 cloud: atol 1e-3 (sums of up to 27 x 384 terms a
    voxel in two orders)."""
    port = t_fcgf.load_fcgf(RELEASE, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == 15_843_840
    tree = flax_msgpack.load(RELEASE)
    pts = cloud(6, 2000)
    occ, idx, _ = t_fcgf.voxelize(pts, 0.05, GRID)
    ref = np.asarray(jax.jit(lambda v, x: j_fcgf.VoxelFCGF().apply(v, x, train=False))(
        tree, occ.transpose(1, 2, 3, 0)[None]))[0]
    with torch.no_grad():
        out = channels_last(port(torch.from_numpy(occ)[None]))[0]
    u = np.unique(idx, axis=0)
    np.testing.assert_allclose(out[u[:, 0], u[:, 1], u[:, 2]], ref[u[:, 0], u[:, 1], u[:, 2]],
                               atol=1e-3)


def test_weight_round_trip(tiny, tmp_path):
    """port -> flax -> port exactly; the port's checkpoint file restores into
    JAX's variables through ``flax.serialization.from_bytes`` with the same
    arrays, and the port reads it back equal."""
    model, variables, port = tiny
    state = port.state_dict()
    back = from_flax_fcgf_variables(to_flax_fcgf_variables(state))
    assert back.keys() == state.keys()
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    path = tmp_path / "fcgf.pkl"
    save_fcgf_checkpoint(port, str(path))
    target = jax.tree_util.tree_map(np.zeros_like, variables)
    with open(path, "rb") as f:
        restored = serialization.from_bytes(target, f.read())
    for (p1, a), (p2, b) in zip(jax.tree_util.tree_leaves_with_path(restored),
                                jax.tree_util.tree_leaves_with_path(variables)):
        assert p1 == p2
        np.testing.assert_array_equal(np.asarray(a), b)
    reread = t_fcgf.VoxelFCGF(**TINY, device="cpu")
    reread.load_state_dict(from_flax_fcgf_variables(flax_msgpack.load(str(path))))
    for key, value in reread.state_dict().items():
        assert torch.equal(value, state[key]), key
