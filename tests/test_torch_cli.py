"""The port's five CLIs through ``main(argv)`` with ``--device cpu`` on the
JAX tests' fake data roots (``write_fake_root``, ``write_fake_kitti``,
``write_fake_train_root``), at 2 layers, C = 32, k = 16, each in a working
directory of its own (the CLIs read ``snapshot/<id>/`` from it and write
``logs/`` into it).

Held:
  * each eval CLI's stats equal the port's ``Evaluator.run_dataset`` on the
    port's dataset in every column but the two times, bit for bit;
  * ``test_3DMatch`` and ``test_KITTI`` against the JAX CLI's ``main(argv)``
    on the same root and snapshot (one JAX run takes ~25 s here): success
    flags, inlier counts, ratios, precision, recall, F1 and scene exactly;
    TE within 1e-3 cm; RE within 1e-3 deg where it exceeds 1 deg, and as
    cos(RE) within 1e-6 everywhere (near 0, arccos turns a 1e-7 rounding of
    the rotation's trace into ~0.03 deg: both packages' transforms are
    float32);
  * the log and ``.npy`` names are the JAX CLI's;
  * ``--solver RANSAC`` runs, its stats the Evaluator's with the RANSAC
    solver; ``--sharded`` and ``--sp`` raise NotImplementedError, and a CLI
    left at ``--device cuda`` raises without a card;
  * the train CLIs write a ``config.json`` that both packages' ``Config.load``
    read to the same fields, the source copies, and a checkpoint that
    ``load_model_weights`` reads; their train Loader batches equal the JAX
    Loader's on the same split, bit for bit.
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from pointdsc_tpu.data import kitti as j_kitti  # noqa: E402
from pointdsc_tpu.data import pipeline as j_pipe  # noqa: E402
from pointdsc_tpu.data import threedmatch as j_3dm  # noqa: E402
from pointdsc_tpu.train import config as j_config  # noqa: E402
from pointdsc_tpu_torch.data import kitti as t_kitti  # noqa: E402
from pointdsc_tpu_torch.data import pipeline as t_pipe  # noqa: E402
from pointdsc_tpu_torch.data import threedmatch as t_3dm  # noqa: E402
from pointdsc_tpu_torch.data.predator import PredatorLoMatchDataset  # noqa: E402
from pointdsc_tpu_torch.eval.runner import Evaluator  # noqa: E402
from pointdsc_tpu_torch.evaluation import test_3DLoMatch as t_lomatch  # noqa: E402
from pointdsc_tpu_torch.evaluation import test_3DMatch as t_3dmatch  # noqa: E402
from pointdsc_tpu_torch.evaluation import test_KITTI as t_kitti_cli  # noqa: E402
from pointdsc_tpu_torch import train_3DMatch as t_train3dm  # noqa: E402
from pointdsc_tpu_torch import train_KITTI as t_train_kitti  # noqa: E402
from pointdsc_tpu_torch.models import PointDSC  # noqa: E402
from pointdsc_tpu_torch.train import config as t_config  # noqa: E402
from pointdsc_tpu_torch.train.trainer import Trainer, load_model_weights  # noqa: E402
from test_eval_cli_integration import SCENE, write_fake_root  # noqa: E402
from test_kitti_cli_integration import write_fake_kitti  # noqa: E402
from chip_smoke import write_lomatch_pickle  # noqa: E402
from test_torch_datasets import write_predator_pairs  # noqa: E402
from test_train_cli_integration import SCENE as TRAIN_SCENE  # noqa: E402
from test_train_cli_integration import write_fake_train_root  # noqa: E402

# scenes of the packaged split files, which the train CLIs read
SPLIT_SCENES = {"train": "sun3d-brown_bm_1-brown_bm_1", "val": "sun3d-brown_bm_4-brown_bm_4"}
TIME_COLUMNS = (9, 10)
EXACT_COLUMNS = [0, 3, 4, 5, 6, 7, 8, 11]
SMALL = dict(num_layers=2, num_channels=32, k=16, ratio=0.2, verbose=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread (the training tests' setting)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def write_snapshot(workdir, exp_id, dataset, root, **over):
    """``<workdir>/snapshot/<exp_id>/``: config.json and a random-weight
    ``models/model_best.pkl`` written by the port's Trainer."""
    cfg = t_config.default_config(dataset)
    for k, v in dict(SMALL, **over).items():
        setattr(cfg, k, v)
    cfg.root, cfg.exp_id, cfg.tboard_dir = root, exp_id, ""
    cfg.snapshot_dir = os.path.join(workdir, "snapshot", exp_id)
    cfg.save_dir = os.path.join(cfg.snapshot_dir, "models")
    cfg.save(os.path.join(cfg.snapshot_dir, "config.json"))
    trainer = Trainer(cfg, device="cpu")
    trainer.save_checkpoint(trainer.init_state(steps_per_epoch=1), "best")
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(51)
    out = {"base": str(base)}
    out["3dmatch"] = str(base / "3dmatch")
    poses = write_fake_root(out["3dmatch"], rng, num_frag=3, n_pts=400)
    write_lomatch_pickle(out["3dmatch"], SCENE, poses)
    out["predator"] = str(base / "predator")
    write_predator_pairs(out["predator"], rng, num_pairs=2)

    out["kitti"] = str(base / "kitti")
    for split, n in (("train", 8), ("val", 4), ("test", 3)):
        write_fake_kitti(out["kitti"], rng, num_pairs=n, n_pts=400)
        if split != "test":
            os.rename(os.path.join(out["kitti"], "fcgf_test"),
                      os.path.join(out["kitti"], f"fcgf_{split}"))

    out["train"] = str(base / "train")
    write_fake_train_root(out["train"], rng, num_frag=5, n_pts=300)
    lists = os.path.join(out["train"], "threedmatch")
    for scene in SPLIT_SCENES.values():  # the same pairs under packaged scene names
        shutil.copy(os.path.join(lists, f"{TRAIN_SCENE}@seq-01-0.30.txt"),
                    os.path.join(lists, f"{scene}@seq-01-0.30.txt"))
    return out


def workdir(data, name, snapshots):
    """A fresh working directory holding copies of the named snapshots."""
    wd = os.path.join(data["base"], f"wd_{name}")
    os.makedirs(wd)
    for exp_id, (dataset, root) in snapshots.items():
        write_snapshot(wd, exp_id, dataset, root)
    return wd


def assert_stats_close(out, ref):
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out[:, EXACT_COLUMNS], ref[:, EXACT_COLUMNS])
    np.testing.assert_allclose(np.cos(np.radians(out[:, 1])), np.cos(np.radians(ref[:, 1])),
                               atol=1e-6)
    big = ref[:, 1] > 1.0
    np.testing.assert_allclose(out[big, 1], ref[big, 1], atol=1e-3)
    np.testing.assert_allclose(out[:, 2], ref[:, 2], atol=1e-3)


def assert_same_as_evaluator(stats, model_cfg, snapshot, dataset, scene_of=None, **ev_kw):
    """The CLI's stats against the port's Evaluator on the port's dataset."""
    model = PointDSC(in_dim=model_cfg.in_dim, num_layers=model_cfg.num_layers,
                     num_channels=model_cfg.num_channels, num_iterations=model_cfg.num_iterations,
                     ratio=model_cfg.ratio, sigma_d=model_cfg.sigma_d, k=model_cfg.k,
                     inlier_threshold=model_cfg.inlier_threshold,
                     nms_radius=model_cfg.inlier_threshold, device="cpu")
    load_model_weights(model, os.path.join(snapshot, "models", "model_best.pkl"))
    ev = Evaluator(model, re_thre=model_cfg.re_thre, te_thre=model_cfg.te_thre, device="cpu",
                   icp_threshold=model_cfg.inlier_threshold, **ev_kw)
    ref, _ = ev.run_dataset(dataset, scene_of=scene_of, verbose=False)
    keep = [c for c in range(12) if c not in TIME_COLUMNS]
    np.testing.assert_array_equal(stats[:, keep], ref[:, keep])


@pytest.mark.parametrize("use_icp", [False, True])
def test_3dmatch_cli(data, monkeypatch, use_icp):
    wd = workdir(data, f"3dmatch_icp{use_icp}", {"itest": ("3DMatch", data["3dmatch"])})
    monkeypatch.chdir(wd)
    argv = ["--chosen_snapshot", "itest", "--save_npy", "true", "--use_icp", str(use_icp)]
    stats, agg = t_3dmatch.main(argv + ["--device", "cpu"])
    assert stats.shape == (3, 12) and agg["pair_recall"] >= 200 / 3
    name = f"itest-SVD-fcgf{'-ICP' if use_icp else ''}"
    assert sorted(os.listdir("logs")) == [f"{name}.log", f"{name}.npy"]
    np.testing.assert_array_equal(np.load(f"logs/{name}.npy"), stats)
    with open(f"logs/{name}.log") as f:
        assert f.readline().startswith("itest on cpu: fused_attention=False, guard flipped=False")

    cfg = t_config.Config.load("snapshot/itest/config.json")
    ds = t_3dm.ThreeDMatchTest(data["3dmatch"], device="cpu")
    assert_same_as_evaluator(stats, cfg, "snapshot/itest", ds, scene_of=ds.scene_of,
                             use_icp=use_icp)

    if not use_icp:  # the JAX CLI, in a working directory of its own
        from evaluation.test_3DMatch import main as jax_main

        jax_wd = os.path.join(data["base"], "wd_3dmatch_jax")
        shutil.copytree(os.path.join(wd, "snapshot"), os.path.join(jax_wd, "snapshot"))
        monkeypatch.chdir(jax_wd)
        ref, _ = jax_main(argv)
        assert_stats_close(stats, ref)
        assert sorted(os.listdir("logs")) == [f"{name}.log", f"{name}.npy"]


def test_3dmatch_cli_fused_on_cpu(data, monkeypatch, capsys):
    """``--fused_attention true`` on the CPU: the fused forward's plain
    versions behind the regime guard, whose slack the report's header
    prints; the same registrations as the dense run."""
    wd = workdir(data, "3dmatch_fused", {"itest": ("3DMatch", data["3dmatch"])})
    monkeypatch.chdir(wd)
    dense, _ = t_3dmatch.main(["--chosen_snapshot", "itest", "--device", "cpu"])
    capsys.readouterr()
    fused, _ = t_3dmatch.main(["--chosen_snapshot", "itest", "--device", "cpu",
                               "--fused_attention", "true"])
    header = capsys.readouterr().out.splitlines()[0]
    assert header.startswith("itest on cpu: fused_attention=True, guard flipped=")
    assert "nats" in header
    np.testing.assert_array_equal(fused[:, 0], dense[:, 0])
    np.testing.assert_allclose(fused[:, 2], dense[:, 2], atol=1e-2)


def kitti_reference(data):
    """The KITTI CLI's model config (the snapshot's with the outdoor
    thresholds), snapshot and dataset at --num_node 400."""
    cfg = t_config.Config.load("snapshot/ktest/config.json")
    cfg.inlier_threshold, cfg.sigma_d, cfg.re_thre, cfg.te_thre = 0.6, 1.2, 5.0, 60.0
    ds = t_kitti.KITTIDataset(data["kitti"], split="test", num_node=400,
                              use_mutual=cfg.use_mutual, inlier_threshold=0.6, augment_axis=0,
                              augment_rotation=0.0, augment_translation=0.0, device="cpu")
    return cfg, "snapshot/ktest", ds


def test_kitti_cli(data, monkeypatch):
    wd = workdir(data, "kitti", {"ktest": ("KITTI", data["kitti"])})
    monkeypatch.chdir(wd)
    argv = ["--chosen_snapshot", "ktest", "--num_node", "400", "--save_npy", "true"]
    stats, agg = t_kitti_cli.main(argv + ["--device", "cpu"])
    assert stats.shape == (3, 12) and agg["pair_recall"] == 100.0
    name = "ktest-SVD-fcgf-KITTI"
    assert sorted(os.listdir("logs")) == [f"{name}.log", f"{name}.npy"]

    assert_same_as_evaluator(stats, *kitti_reference(data))

    from evaluation.test_KITTI import main as jax_main

    jax_wd = os.path.join(data["base"], "wd_kitti_jax")
    shutil.copytree(os.path.join(wd, "snapshot"), os.path.join(jax_wd, "snapshot"))
    monkeypatch.chdir(jax_wd)
    ref, _ = jax_main(argv)
    assert_stats_close(stats, ref)
    assert sorted(os.listdir("logs")) == [f"{name}.log", f"{name}.npy"]


@pytest.mark.parametrize("predator", [False, True])
def test_3dlomatch_cli(data, monkeypatch, predator):
    """Both sources of 3DLoMatch pairs. The benchmark reads 1781 Predator
    files; the fake directory holds two, so the dataset's length is set to
    two for this test."""
    wd = workdir(data, f"lomatch_{predator}", {"itest": ("3DMatch", data["3dmatch"])})
    monkeypatch.chdir(wd)
    argv = ["--chosen_snapshot", "itest", "--num_corr", "256", "--device", "cpu",
            "--save_npy", "true"]
    if predator:
        argv += ["--use_predator", "true", "--predator_root", data["predator"]]
        monkeypatch.setattr(PredatorLoMatchDataset, "__len__", lambda self: 2)
    stats, _ = t_lomatch.main(argv)
    # the JAX CLI's names: logs/<snapshot>-3DLoMatch-<descriptor>.log / .npy
    assert sorted(os.listdir("logs")) == ["itest-3DLoMatch-fcgf.log", "itest-3DLoMatch-fcgf.npy"]
    cfg = t_config.Config.load("snapshot/itest/config.json")
    if predator:
        ds = PredatorLoMatchDataset(data["predator"], n_points=256)
    else:
        ds = t_3dm.ThreeDLoMatchTest(data["3dmatch"], num_node=256, device="cpu")
    assert stats.shape == (len(ds), 12) and len(ds) in (2, 3)
    assert_same_as_evaluator(stats, cfg, "snapshot/itest", ds)


CLIS = {"3DMatch": (t_3dmatch.main, "itest", []),
        "KITTI": (t_kitti_cli.main, "ktest", ["--num_node", "400"]),
        "3DLoMatch": (t_lomatch.main, "itest", ["--num_corr", "256"])}
REFUSED = [(cli, flag) for cli in CLIS for flag in ("RANSAC", "sharded", "sp")
           if not (cli == "3DLoMatch" and flag == "RANSAC")]


@pytest.fixture(scope="module")
def refusal_dir(data):
    return workdir(data, "refusals", {"itest": ("3DMatch", data["3dmatch"]),
                                      "ktest": ("KITTI", data["kitti"])})


@pytest.mark.parametrize("cli,flag", REFUSED)
def test_cli_refuses_unported(data, refusal_dir, monkeypatch, cli, flag):
    """The Evaluator's NotImplementedErrors reach the user: --sharded needs
    several cards, --sp the sequence-parallel encoder (ROADMAP Queue A).
    ``--solver RANSAC``, refused until the classical baselines were ported,
    now runs: its stats are the Evaluator's with the RANSAC solver, written
    under the JAX CLI's log name."""
    monkeypatch.chdir(refusal_dir)
    main, snap, extra = CLIS[cli]
    argv = ["--chosen_snapshot", snap, "--device", "cpu"] + extra
    argv += {"RANSAC": ["--solver", "RANSAC"], "sharded": ["--sharded", "true"],
             "sp": ["--sp", "true"]}[flag]
    if flag != "RANSAC":
        with pytest.raises(NotImplementedError):
            main(argv)
        return
    stats, agg = main(argv)
    if cli == "3DMatch":
        log = "logs/itest-RANSAC-fcgf.log"
        cfg = t_config.Config.load("snapshot/itest/config.json")
        ds = t_3dm.ThreeDMatchTest(data["3dmatch"], device="cpu")
        assert_same_as_evaluator(stats, cfg, "snapshot/itest", ds, scene_of=ds.scene_of,
                                 solver="RANSAC")
    else:
        log = "logs/ktest-RANSAC-fcgf-KITTI.log"
        assert_same_as_evaluator(stats, *kitti_reference(data), solver="RANSAC")
    assert os.path.exists(log) and stats.shape == (3, 12) and np.isfinite(stats).all()
    assert agg["pair_recall"] >= 200 / 3


@pytest.mark.parametrize("cli", list(CLIS) + ["train_3DMatch", "train_KITTI"])
def test_cli_needs_card_by_default(refusal_dir, monkeypatch, cli):
    """Left at its default device, every CLI raises without a card rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(refusal_dir)
    if cli.startswith("train"):
        main = {"train_3DMatch": t_train3dm.main, "train_KITTI": t_train_kitti.main}[cli]
        argv = ["--snapshot_dir", "snapshot/refused", "--root", "unused"]
    else:
        main, snap, extra = CLIS[cli]
        argv = ["--chosen_snapshot", snap] + extra
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_sp_and_sharded_exclusive(refusal_dir, monkeypatch):
    monkeypatch.chdir(refusal_dir)
    with pytest.raises(SystemExit):
        t_3dmatch.main(["--chosen_snapshot", "itest", "--device", "cpu", "--sp", "true",
                        "--sharded", "true"])


def train_argv(root, snapshot_dir, dataset):
    argv = ["--root", root, "--num_layers", "2", "--num_channels", "32", "--k", "16",
            "--num_node", "128", "--batch_size", "4", "--max_epoch", "1",
            "--training_max_iter", "2", "--val_max_iter", "1", "--num_workers", "2",
            "--snapshot_dir", snapshot_dir, "--tboard_dir", "", "--device", "cpu"]
    if dataset == "KITTI":
        argv += ["--inlier_threshold", "0.6"]
    return argv


def loader_batches(loader):
    return [{k: v.copy() for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("dataset", ["3DMatch", "KITTI"])
def test_train_cli(data, monkeypatch, dataset):
    wd = os.path.join(data["base"], f"wd_train_{dataset}")
    os.makedirs(wd)
    monkeypatch.chdir(wd)
    root = data["train"] if dataset == "3DMatch" else data["kitti"]
    snap = os.path.join(wd, "snapshot", "t")
    main = t_train3dm.main if dataset == "3DMatch" else t_train_kitti.main
    state = main(train_argv(root, snap, dataset))
    assert state.step == 2

    # config.json: both packages read the same fields
    path = os.path.join(snap, "config.json")
    t_cfg, j_cfg = t_config.Config.load(path), j_config.Config.load(path)
    assert dataclasses.asdict(t_cfg) == {k: v for k, v in dataclasses.asdict(j_cfg).items()
                                         if k in dataclasses.asdict(t_cfg)}
    assert (t_cfg.dataset, t_cfg.num_layers, t_cfg.num_node, t_cfg.root) == \
        (dataset, 2, 128, root)
    # and a config.json the JAX package writes, in the port
    j_path = os.path.join(wd, "jax_config.json")
    j_config.default_config(dataset).save(j_path)
    j_cfg = j_config.Config.load(j_path)
    assert dataclasses.asdict(t_config.Config.load(j_path)) == \
        {k: v for k, v in dataclasses.asdict(j_cfg).items() if k in dataclasses.asdict(t_cfg)}
    assert sorted(f for f in os.listdir(os.path.join(snap, "models"))) == \
        ["model_1.pkl", "model_best.pkl"]
    if dataset == "3DMatch":  # the port's sources beside it
        for rel in t_train3dm.SOURCES:
            copied = os.path.join(snap, os.path.basename(rel))
            with open(copied) as a, open(os.path.join(t_train3dm.HERE, rel)) as b:
                assert a.read() == b.read()
    # one epoch: the best checkpoint holds the final weights
    model = PointDSC(num_layers=2, num_channels=32, k=16, device="cpu")
    load_model_weights(model, os.path.join(snap, "models", "model_best.pkl"))
    final = state.model.state_dict()
    for name, value in model.state_dict().items():
        assert torch.equal(value, final[name]), name

    # the train Loader's batches: the port's datasets against the JAX ones
    kw = dict(root=root, descriptor="fcgf", in_dim=6, inlier_threshold=t_cfg.inlier_threshold,
              num_node=128, use_mutual=False, augment_axis=t_cfg.augment_axis,
              augment_rotation=t_cfg.augment_rotation,
              augment_translation=t_cfg.augment_translation)
    if dataset == "3DMatch":
        pair = (j_3dm.ThreeDMatchTrainVal(split="train", **kw),
                t_3dm.ThreeDMatchTrainVal(split="train", **kw, device="cpu"))
    else:
        pair = (j_kitti.KITTIDataset(split="train", **kw),
                t_kitti.KITTIDataset(split="train", **kw, device="cpu"))
    ref = loader_batches(j_pipe.Loader(pair[0], 4, shuffle=True, num_workers=2))
    out = loader_batches(t_pipe.Loader(pair[1], 4, shuffle=True, num_workers=2))
    assert len(out) == len(ref) == 2
    for b_out, b_ref in zip(out, ref):
        assert sorted(b_out) == sorted(b_ref)
        for k in b_ref:
            np.testing.assert_array_equal(b_out[k], b_ref[k], err_msg=k)
