"""The port's sharded evaluation (``Evaluator.run_dataset_sharded``) against
the JAX package's and against the port's sequential ``run_dataset``, as
``tests/test_sharded_eval.py`` holds JAX's: the same success flags, TE
within 1e-3 cm and RE within 1e-3 deg, over 10 pairs on a mesh of 8 (a full
batch and a padded one). RE is held so where it exceeds 1 deg, and as
cos(RE) within 1e-6 everywhere: near 0, arccos turns a 1e-7 rounding of the
rotation's trace into ~0.03 deg (``tests/test_torch_cli.py``'s rule), and a
batch of 8 pairs runs its products in other orders than one pair does.
The port runs on ``[cpu] * 8`` (one model replica, the eight pairs of a
batch as one batch), JAX on the suite's 8 virtual devices. Then
``--sharded`` and ``--sp`` through the port's 3DMatch CLI on the fake root of
``tests/test_torch_cli.py``, with the fused path (its kernels' plain
versions on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.data.synthetic import SyntheticPairDataset as JaxSyntheticPairDataset
from pointdsc_tpu.eval.runner import Evaluator as JaxEvaluator
from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.data import threedmatch as t_3dm
from pointdsc_tpu_torch.eval.runner import Evaluator
from pointdsc_tpu_torch.evaluation import test_3DMatch as t_3dmatch
from pointdsc_tpu_torch.models import PointDSC
from pointdsc_tpu_torch.train import config as t_config
from tests.test_eval_cli_integration import write_fake_root
from tests.test_torch_cli import assert_same_as_evaluator, write_snapshot


def assert_registration_close(out, ref):
    np.testing.assert_array_equal(out[:, 0], ref[:, 0])
    np.testing.assert_allclose(out[:, 2], ref[:, 2], atol=1e-3)
    np.testing.assert_allclose(np.cos(np.radians(out[:, 1])), np.cos(np.radians(ref[:, 1])),
                               atol=1e-6)
    big = ref[:, 1] > 1.0
    np.testing.assert_allclose(out[big, 1], ref[big, 1], atol=1e-3)


KW = dict(in_dim=6, num_layers=2, num_channels=32, k=16, ratio=0.2)
DATA = dict(num_pairs=10, num_corr=256, inlier_ratio=0.6, seed=5)


@pytest.fixture(scope="module")
def sequential(models):
    """The port's sequential run of the dataset, dense and fused."""
    tm = models[2]
    return {fused: Evaluator(tm, fused_attention=fused, device="cpu").run_dataset(
        SyntheticPairDataset(**DATA), verbose=False) for fused in (False, True)}


@pytest.fixture(scope="module")
def models():
    jm = JaxPointDSC(**KW)
    s = JaxSyntheticPairDataset(**DATA)[0]
    variables = jax.jit(jm.init)(jax.random.key(0), *(jnp.asarray(s[k])[None] for k in (
        "corr_pos", "src_keypts", "tgt_keypts")))
    tm = PointDSC(**KW, device="cpu")
    tm.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                       strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_matches_jax_and_sequential(models, sequential, fused):
    """10 pairs on a mesh of 8: the port's sharded run against its
    sequential run, and the dense one against JAX's sharded run (the JAX
    test's setting; the fused one runs the kernels' plain versions, held to
    the sequential fused run)."""
    jm, variables, tm = models
    assert jax.device_count() == 8
    ds = SyntheticPairDataset(**DATA)
    ev = Evaluator(tm, fused_attention=fused, device="cpu")
    seq, agg_seq = sequential[fused]
    sharded, agg = ev.run_dataset_sharded(ds, mesh=[torch.device("cpu")] * 8, verbose=False)
    others = [seq]
    if not fused:
        jev = JaxEvaluator(jm, variables)
        others.append(jev.run_dataset_sharded(JaxSyntheticPairDataset(**DATA),
                                              mesh=jax_make_mesh(), verbose=False)[0])
    assert sharded.shape == (len(ds), 12)
    assert agg["model_time_semantics"] == "batch-amortized: wall/n over 8-pair sharded dispatches"
    for other in others:
        assert_registration_close(sharded, other)
    assert agg["pair_recall"] == agg_seq["pair_recall"]
    assert np.all(sharded[:, 9] > 0)


def test_sharded_three_entries_padded(models, sequential):
    """A mesh of three entries keeps the pairs in order: ``[cpu] * 3`` (4
    batches, the last padded with two repeats) against the sequential run."""
    _, _, tm = models
    ev = Evaluator(tm, device="cpu")
    sharded, _ = ev.run_dataset_sharded(SyntheticPairDataset(**DATA), mesh=["cpu"] * 3,
                                        verbose=False)
    assert_registration_close(sharded, sequential[False][0])


@pytest.mark.parametrize("flag", ["--sharded", "--sp"])
def test_3dmatch_cli_sharded_and_sp(tmp_path, monkeypatch, flag):
    """``--sharded true`` and ``--sp true`` with ``--fused_attention true``
    through the port's 3DMatch CLI on the CPU: the stats of the Evaluator's
    sharded run (or of the Evaluator with a mesh of the CPU device) in every
    column but the two times, and the fake root's pairs registered."""
    root = str(tmp_path / "3dmatch")
    write_fake_root(root, np.random.default_rng(51), num_frag=3, n_pts=400)
    wd = tmp_path / "wd"
    os.makedirs(wd)
    write_snapshot(str(wd), "itest", "3DMatch", root)
    monkeypatch.chdir(wd)
    stats, agg = t_3dmatch.main(["--chosen_snapshot", "itest", "--device", "cpu",
                                 "--fused_attention", "true", flag, "true"])
    cfg = t_config.Config.load("snapshot/itest/config.json")
    ds = t_3dm.ThreeDMatchTest(root, device="cpu")
    kw = {"sharded": True} if flag == "--sharded" else {"sp_mesh": [torch.device("cpu")]}
    assert_same_as_evaluator(stats, cfg, "snapshot/itest", ds, scene_of=ds.scene_of,
                             fused_attention=True, **kw)
    assert stats.shape == (3, 12) and agg["pair_recall"] >= 200 / 3
