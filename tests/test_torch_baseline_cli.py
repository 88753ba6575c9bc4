"""The port's baseline CLIs (``pointdsc_tpu_torch/baseline_scripts/``) and
``Evaluator(solver="RANSAC")`` against the JAX package's, on the CPU.

Both CLIs run through ``main(argv)`` at ``--num_node 256 --max_iteration
256`` on the JAX tests' fake roots (``write_fake_root``,
``write_fake_kitti``), each package in a working directory of its own, the
JAX one with 64-bit types off (its accelerator's mode). SM, LS and PMC run as
they are; RANSAC and GCRANSAC on the JAX runner's own draws: the port's
``draw_minimal_sets`` is replaced by ``jax.random.randint`` on the JAX
runner's per-pair ``split`` of ``key(0)``. Held on every pair: the success
flag and every column of counts and ratios within 1e-5, the ``.npy`` names;
on the pairs that register in both packages also RE and TE within 1e-5 (RE
as cos(RE): near 0 arccos turns a 1e-7 rounding of the rotation's trace into
~0.03 deg; TE, in cm, as 1e-5 m: 1e-5 cm is below one float32 step of a
KITTI coordinate of 20 m). A pair that fails (RE ~ 180 deg; RANSAC at 256
hypotheses on the 3DMatch root's ~8% inliers) was fit on the 2-6 points of
its labels, the same points in both packages, and a rigid fit that
ill-conditioned differs by up to ~1e-3 between two float32 implementations.
``--device cuda`` raises without a card before any data is read.

``Evaluator(solver="RANSAC")``, with and without ICP, against the JAX
Evaluator on ``tests/test_solver_variants.py``'s 2-layer C = 32 model
through the weight bridge, on ``key(51)``'s draws.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pointdsc_tpu.data import SyntheticPairDataset  # noqa: E402
from pointdsc_tpu.eval.runner import Evaluator as JaxEvaluator  # noqa: E402
from pointdsc_tpu.models import PointDSC as JaxPointDSC  # noqa: E402
from pointdsc_tpu_torch import Evaluator, PointDSC  # noqa: E402
from pointdsc_tpu_torch.baseline_scripts import baseline_3DMatch as t_b3dm  # noqa: E402
from pointdsc_tpu_torch.baseline_scripts import baseline_KITTI as t_bkitti  # noqa: E402
from pointdsc_tpu_torch.baselines import classical as tc  # noqa: E402
from pointdsc_tpu_torch.compat.weights import from_flax_variables  # noqa: E402
from test_eval_cli_integration import write_fake_root  # noqa: E402
from test_kitti_cli_integration import write_fake_kitti  # noqa: E402

TIME_COLUMNS = (9, 10)
COUNT_COLUMNS = [0, 3, 4, 5, 6, 7, 8, 11]
METHODS = [("SM", []), ("RANSAC", []), ("GCRANSAC", ["--gc_minimizer", "icm"]),
           ("GCRANSAC", ["--gc_minimizer", "exact"]), ("LS", []), ("PMC", [])]


def x32():
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("baselines")
    rng = np.random.default_rng(51)
    out = {"base": str(base), "3DMatch": str(base / "3dmatch"), "KITTI": str(base / "kitti")}
    write_fake_root(out["3DMatch"], rng, num_frag=3, n_pts=300)
    write_fake_kitti(out["KITTI"], rng, num_pairs=2, n_pts=300)
    return out


def split_draws():
    """``draw_minimal_sets`` as the JAX runner draws: one split of key(0) per
    call."""
    state = {}

    def draw(b, h, n, generator, device):
        with x32():
            key = state.get("key", jax.random.key(0))
            state["key"], sub = jax.random.split(key)
            idx = jax.random.randint(sub, (b, h, 3), 0, n)
        return torch.tensor(np.asarray(idx), dtype=torch.int64, device=device)
    return draw


def cli_mains(cli):
    if cli == "3DMatch":
        from baseline_scripts.baseline_3DMatch import main as jax_main
        return t_b3dm.main, jax_main, "baseline"
    from baseline_scripts.baseline_KITTI import main as jax_main
    return t_bkitti.main, jax_main, "baseline-kitti"


@pytest.mark.parametrize("method,extra", METHODS,
                         ids=["SM", "RANSAC", "GCRANSAC-icm", "GCRANSAC-exact", "LS", "PMC"])
@pytest.mark.parametrize("cli", ["3DMatch", "KITTI"])
def test_baseline_cli_matches_jax(roots, monkeypatch, cli, method, extra):
    port_main, jax_main, tag = cli_mains(cli)
    argv = ["--method", method, "--root", roots[cli], "--num_node", "256",
            "--max_iteration", "256", "--save_npy", "true"] + extra
    name = f"{tag}-{method}-fcgf.npy"
    wd = os.path.join(roots["base"], f"wd_{cli}_{method}_{'_'.join(extra)}")
    os.makedirs(os.path.join(wd, "port"))
    os.makedirs(os.path.join(wd, "jax"))

    monkeypatch.chdir(os.path.join(wd, "port"))
    monkeypatch.setattr(tc, "draw_minimal_sets", split_draws())
    stats, agg = port_main(argv + ["--device", "cpu"])
    assert os.listdir("logs") == [name]
    np.testing.assert_array_equal(np.load(os.path.join("logs", name)), stats)

    monkeypatch.chdir(os.path.join(wd, "jax"))
    with x32():
        ref, ref_agg = jax_main(argv)
    assert os.listdir("logs") == [name]

    assert stats.shape == ref.shape == ((3, 12) if cli == "3DMatch" else (2, 12))
    np.testing.assert_allclose(stats[:, COUNT_COLUMNS], ref[:, COUNT_COLUMNS], atol=1e-5)
    ok = ref[:, 0] == 1.0
    np.testing.assert_allclose(np.cos(np.radians(stats[ok, 1])), np.cos(np.radians(ref[ok, 1])),
                               atol=1e-5)
    np.testing.assert_allclose(stats[ok, 2] / 100.0, ref[ok, 2] / 100.0, atol=1e-5)
    if method in ("SM", "LS", "PMC") or cli == "KITTI":
        assert ok.any()
    assert agg["pair_recall"] == ref_agg["pair_recall"]
    assert (stats[:, 9] > 0).all() and (stats[:, 10] == 0).all()


@pytest.mark.parametrize("cli", ["3DMatch", "KITTI"])
def test_baseline_cli_needs_card_by_default(tmp_path, monkeypatch, cli):
    """Left at --device cuda, a CLI raises without a card, before it reads
    any data (the root does not exist)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_mains(cli)[0](["--root", str(tmp_path / "missing")])


def test_baseline_cli_runs_the_draws_of_one_generator(roots, monkeypatch):
    """Without injected draws: one CPU generator seeded 0, advanced pair by
    pair, so two runs agree and the pairs draw different sets."""
    monkeypatch.chdir(roots["base"])
    calls = []
    draw = tc.draw_minimal_sets

    def spy(b, h, n, generator, device):
        calls.append(draw(b, h, n, generator, device))
        return calls[-1]

    monkeypatch.setattr(tc, "draw_minimal_sets", spy)
    argv = ["--method", "RANSAC", "--root", roots["3DMatch"], "--num_node", "256",
            "--max_iteration", "64", "--device", "cpu"]
    first, _ = t_b3dm.main(argv)
    second, _ = t_b3dm.main(argv)
    keep = [c for c in range(12) if c not in TIME_COLUMNS]
    np.testing.assert_array_equal(first[:, keep], second[:, keep])
    assert len(calls) == 6 and torch.equal(calls[0], calls[3])
    assert not torch.equal(calls[0], calls[1])
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(calls[0], torch.randint(0, 256, (1, 64, 3), generator=gen))


@pytest.fixture(scope="module")
def small_models():
    """``tests/test_solver_variants.py``'s model and pairs: the JAX model
    with its init and the same weights in the port's model."""
    jm = JaxPointDSC(in_dim=6, num_layers=2, num_channels=32, k=16, ratio=0.2)
    ds = SyntheticPairDataset(num_pairs=3, num_corr=256, inlier_ratio=0.6, seed=4)
    s = ds[0]
    variables = jm.init(jax.random.key(0), jnp.asarray(s["corr_pos"])[None],
                        jnp.asarray(s["src_keypts"])[None], jnp.asarray(s["tgt_keypts"])[None])
    tm = PointDSC(in_dim=6, num_layers=2, num_channels=32, k=16, ratio=0.2, device="cpu")
    tm.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                       strict=True)
    return jm, variables, tm, ds


@pytest.mark.parametrize("use_icp", [False, True])
def test_evaluator_ransac_matches_jax(small_models, monkeypatch, use_icp):
    """Each forward draws afresh from key(51) (JAX) or a generator seeded 51
    (the port); here both from key(51). Transforms within 1e-4, the counts
    of the stats equal, every pair registered."""
    jm, variables, tm, ds = small_models

    def draw(b, h, n, generator, device):
        assert generator.initial_seed() == 51 and h == 4096
        with x32():
            idx = jax.random.randint(jax.random.key(51), (b, h, 3), 0, n)
        return torch.tensor(np.asarray(idx), dtype=torch.int64, device=device)

    monkeypatch.setattr(tc, "draw_minimal_sets", draw)
    tev = Evaluator(tm, solver="RANSAC", use_icp=use_icp, icp_threshold=0.10, device="cpu")
    svd = Evaluator(tm, use_icp=use_icp, icp_threshold=0.10, device="cpu")
    with x32():
        jev = JaxEvaluator(jm, variables, solver="RANSAC", use_icp=use_icp, icp_threshold=0.10)
    moved = 0.0
    for i in range(len(ds)):
        with x32():
            jrow, jt = jev.run_pair(ds[i])
        trow, tt = tev.run_pair(ds[i])
        _, t0 = svd.run_pair(ds[i])
        np.testing.assert_allclose(tt, jt, atol=1e-4)
        for col in (0, 3, 4, 5):
            assert trow[col] == jrow[col]
        assert trow[0] == 1.0
        moved = max(moved, float(np.abs(tt - t0).max()))
    if not use_icp:  # with ICP both solvers' transforms converge to one
        assert moved > 1e-4  # RANSAC re-solved the model's transform
