"""The port's ``tools/train_fcgf.py`` end to end on the CPU at a small size:
two training steps at a 32^3 grid from seeded random weights, the
checkpoint, one held-out pair. The checkpoint restores through JAX's
``flax.serialization.from_bytes`` into the reference VoxelFCGF's variables
at the default widths (what the JAX ``tools/cal_fcgf.py --checkpoint``
reads), and through the port's ``load_fcgf`` back to the same weights; the
held-out pair's FPFH inlier ratio equals the one JAX's FPFH gives on the
same views (both FPFH ports agree there, measured 0.4847 on this pair)."""

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

from pointdsc_tpu.descriptors.fcgf import VoxelFCGF as JaxVoxelFCGF  # noqa: E402
from pointdsc_tpu.descriptors.fpfh import extract_fpfh as j_extract_fpfh  # noqa: E402
from pointdsc_tpu_torch.compat.fcgf_weights import to_flax_fcgf_variables  # noqa: E402
from pointdsc_tpu_torch.descriptors.fcgf import load_fcgf  # noqa: E402
from pointdsc_tpu_torch.tools import train_fcgf  # noqa: E402


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_fcgf") / "fcgf.pkl"
    ir = train_fcgf.main(["--steps", "2", "--grid_size", "32", "--eval_pairs", "1",
                          "--out", str(out), "--device", "cpu"])
    return out, ir


def test_main_runs_and_saves(trained):
    out, (ir_fcgf, ir_fpfh) = trained
    assert out.exists()
    assert 0.0 <= ir_fcgf <= 1.0 and 0.0 < ir_fpfh <= 1.0


def test_checkpoint_restores_in_jax_and_port(trained):
    out, _ = trained
    model = JaxVoxelFCGF()
    target = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 32, 1)))
    restored = serialization.from_bytes(target, out.read_bytes())
    port = load_fcgf(str(out), device="cpu")
    ref = to_flax_fcgf_variables(port.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(restored)
    assert len(leaves) == len(jax.tree_util.tree_leaves(ref)) == 178
    for path, value in leaves:
        got = ref
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(np.asarray(value), got)
    # the training moved the weights off the seeded init
    init = load_fcgf(None, device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(init.state_dict().values(),
                                                      port.state_dict().values()))


def test_held_out_fpfh_matches_jax(trained):
    """The evaluation's first pair (``np.random.default_rng(seed + 777)``):
    FPFH's inlier ratio from JAX's FPFH on the same views equals the port's
    within 1e-3 (one keypoint of ~1400)."""
    _, (_, ir_fpfh) = trained
    *_, (v0, v1, pose) = train_fcgf.make_pair(np.random.default_rng(777), 0.05, 32)
    kp0, fp0 = j_extract_fpfh(v0, voxel_size=0.05)
    kp1, fp1 = j_extract_fpfh(v1, voxel_size=0.05)
    ref = train_fcgf.inlier_ratio(np.asarray(kp0), np.nan_to_num(np.asarray(fp0)),
                                  np.asarray(kp1), np.nan_to_num(np.asarray(fp1)), pose)
    assert abs(ir_fpfh - ref) <= 1e-3
