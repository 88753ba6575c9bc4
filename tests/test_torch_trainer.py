"""The port's Trainer against the JAX Trainer at a small size (2 layers,
C = 32, N = 128, batch 2) from the same converted weights and the same numpy
batches: optimizer steps (parameters, BatchNorm statistics, the learning rate
across a decay boundary, a step whose gradients are not finite), the
checkpoint round trip into both packages, the config's JSON round trip, the
loader, and the training tool end to end on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pointdsc_tpu.data import Loader as JaxLoader
from pointdsc_tpu.data import SyntheticPairDataset as JaxSyntheticPairDataset
from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu.train.config import Config as JaxConfig
from pointdsc_tpu.train.trainer import Trainer as JaxTrainer
from pointdsc_tpu.train.trainer import load_model_weights as jax_load_model_weights
from pointdsc_tpu_torch import load_pretrained, register
from pointdsc_tpu_torch.compat import flax_msgpack
from pointdsc_tpu_torch.compat.weights import from_flax_variables, to_flax_variables
from pointdsc_tpu_torch.data import Loader, SyntheticPairDataset
from pointdsc_tpu_torch.tools import train_synthetic
from pointdsc_tpu_torch.train.config import Config, default_config
from pointdsc_tpu_torch.train.trainer import Trainer, load_model_weights
from tests.test_torch_train_model import make_batch

SMALL = dict(num_layers=2, num_channels=32, k=12, ratio=0.2, batch_size=2, num_node=112,
             tboard_dir="", verbose=False, num_devices=1)
# Below this largest gradient entry a parameter's gradient is rounding noise:
# a Dense bias whose only effect is a constant shift into a training-mode
# BatchNorm has a true gradient of zero (the biases in front of a BatchNorm,
# the value projection's, layer0's, every message MLP's last but the final).
NOISE_GRADIENT = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread is the fastest on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(cls, **over):
    cfg = cls(**{**SMALL, **over})
    return cfg


@pytest.mark.parametrize("optimizer,fused", [("SGD", False), ("ADAM", False), ("ADAM", True)])
def test_train_steps_match_jax_trainer(optimizer, fused):
    """Four train steps on both Trainers, the second with a NaN label (every
    gradient NaN). After each step: BatchNorm statistics atol 1e-5 + rtol 1e-4
    (they advance on the skipped step too), ``grad_finite``, and the parameters.
    The decay boundary lies after two optimizer steps, so the skipped step
    must not count: the fourth call is the first at lr * gamma.

    SGD moves a parameter by lr * gradient, so parameters agree to atol 2e-6
    (dense gradients agree to 1e-4, lr 1e-2). Adam divides by the gradient's
    magnitude: where that is rounding noise (``NOISE_GRADIENT``) the two
    frameworks step by up to lr in either direction. Adam's parameters are
    held to all entries within 2 lr per step taken, and 99% of the entries
    within 1e-5 for every parameter whose gradient was above the noise in
    every step so far."""
    lr, gamma = 1e-2, 0.5
    over = dict(optimizer=optimizer, lr=lr, scheduler_gamma=gamma, training_max_iter=2,
                weight_decay=1e-3, fused_attention=fused, fused_sm_loss=fused)
    jcfg, tcfg = small_config(JaxConfig, **over), small_config(Config, **over)
    batches = [make_batch(seed=s) for s in (1, 2, 3, 4)]
    batches[1]["gt_labels"][0, 0] = np.nan

    jt = JaxTrainer(jcfg)
    jstate = jt.init_state(batches[0], steps_per_epoch=10, seed=0)
    jt.build_steps()
    tt = Trainer(tcfg, device="cpu")
    tstate = tt.init_state(steps_per_epoch=10, seed=0)
    tstate.model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})))

    taken, noisy = 0, set()
    for i, batch in enumerate(batches):
        jstate, jm = jt._train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jnp.asarray(1, jnp.int32))
        tstate, tm = tt.train_step(tstate, tt.to_device(batch), 1)
        finite = float(tm["grad_finite"])
        assert finite == float(jm["grad_finite"]) == (0.0 if i == 1 else 1.0)
        taken += int(finite)
        if finite:
            noisy |= {name for name, p in tstate.model.named_parameters()
                      if float(p.grad.abs().max()) < NOISE_GRADIENT}
        ref = from_flax_variables(jax.tree_util.tree_map(
            np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
        got = tstate.model.state_dict()
        for name, value in ref.items():
            a, b = got[name].numpy(), value.numpy()
            if "running_var" in name or ("running_mean" in name and optimizer == "SGD"):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=f"step {i} {name}")
            elif "running_mean" in name:
                # the noise-stepped biases shift the mean in front of a BatchNorm
                # (not its output): |W| 2 lr per step
                np.testing.assert_allclose(a, b, atol=0.05 * taken, err_msg=f"step {i} {name}")
            elif optimizer == "SGD":
                np.testing.assert_allclose(a, b, atol=2e-6, err_msg=f"step {i} {name}")
            else:
                assert np.abs(a - b).max() <= 2 * lr * taken + 1e-6, f"step {i} {name}"
                if name not in noisy:
                    assert (np.abs(a - b) <= 1e-5).mean() >= 0.99, f"step {i} {name}"
        if finite:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        assert tstate.step == i + 1 == int(jstate.step)
        want_lr = lr * gamma ** (taken // 2)
        assert tstate.scheduler.get_last_lr()[0] == pytest.approx(want_lr, rel=1e-12)
        assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-12)
    assert taken == 3 and 0 < len(noisy) < len(ref) // 2


def test_skipped_step_changes_only_the_running_statistics():
    cfg = small_config(Config, lr=1e-2)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(steps_per_epoch=10, seed=1)
    good, bad = make_batch(seed=1), make_batch(seed=2)
    bad["gt_labels"][1, 3] = np.nan
    state, _ = trainer.train_step(state, trainer.to_device(good), 1)
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = json.dumps(flax_msgpack.loads(flax_msgpack.dumps(
        {"s": [v.tolist() for st in state.optimizer.state_dict()["state"].values()
               for v in st.values()]})))
    state, metrics = trainer.train_step(state, trainer.to_device(bad), 1)
    assert float(metrics["grad_finite"]) == 0.0 and state.step == 2
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, params[name]) == ("running_" not in name), name
    after = json.dumps({"s": [v.tolist() for st in state.optimizer.state_dict()["state"].values()
                              for v in st.values()]})
    assert after == moments
    assert state.scheduler.last_epoch == 1


def test_trainer_refuses_several_devices():
    with pytest.raises(NotImplementedError, match="several cards"):
        Trainer(small_config(Config, num_devices=4), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(small_config(Config))


def test_config_round_trips_between_the_packages(tmp_path):
    """The same fields and defaults, and a config.json written by either
    package loads in the other."""
    for dataset in ("3DMatch", "KITTI"):
        a, b = default_config(dataset), JaxConfig.from_dict(
            json.loads(default_config(dataset).to_json()))
        assert json.loads(a.to_json()) == json.loads(b.to_json())
    assert JaxConfig().to_json() == Config().to_json()
    cfg = small_config(Config, fused_attention=True, sigma_d=1.2)
    cfg.save(str(tmp_path / "a" / "config.json"))
    assert JaxConfig.load(str(tmp_path / "a" / "config.json")).to_json() == cfg.to_json()
    small_config(JaxConfig, remat=True).save(str(tmp_path / "b" / "config.json"))
    assert Config.load(str(tmp_path / "b" / "config.json")).remat is True


def test_checkpoint_round_trip_into_both_packages(tmp_path):
    """The port trains two steps and saves; the JAX package's
    ``load_model_weights`` and the port's ``load_pretrained`` both load the
    file, and the two eval forwards agree (features and transform atol 1e-4,
    the dense model tolerance); ``load_checkpoint`` restores the optimizer,
    the schedule and the step."""
    cfg = small_config(Config, lr=1e-2, snapshot_dir=str(tmp_path),
                       save_dir=str(tmp_path / "models"), training_max_iter=1,
                       scheduler_gamma=0.5)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(steps_per_epoch=10, seed=2)
    for seed in (1, 2):
        state, _ = trainer.train_step(state, trainer.to_device(make_batch(seed=seed)), 1)
    path = trainer.save_checkpoint(state, "best")
    cfg.save(str(tmp_path / "config.json"))

    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    assert set(raw) == {"params", "batch_stats", "step", "torch_optimizer"}
    assert int(raw["step"]) == 2

    batch = make_batch(seed=9)
    jm = JaxPointDSC(**{k: SMALL[k] for k in ("num_layers", "num_channels", "k", "ratio")})
    arrays = [jnp.asarray(batch[k]) for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    variables = jax_load_model_weights(jm, path, arrays)
    out_j = jm.apply(variables, *arrays, mask=jnp.asarray(batch["mask"]), testing=True)

    model = load_pretrained(str(tmp_path), device="cpu")
    assert not model.training
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, model.state_dict()[name]), name
    with torch.no_grad():
        out = model(*(torch.from_numpy(batch[k]) for k in ("corr_pos", "src_keypts",
                                                           "tgt_keypts")),
                    mask=torch.from_numpy(batch["mask"]), fused=False)
    valid = batch["mask"]
    np.testing.assert_allclose(out.normed_features.numpy()[valid],
                               np.asarray(out_j.normed_features)[valid], atol=1e-4)
    np.testing.assert_allclose(out.final_trans.numpy(), np.asarray(out_j.final_trans), atol=1e-4)
    again = load_model_weights(trainer.init_state(10, seed=5).model, path)
    assert torch.equal(again.sigma, model.sigma)

    fresh = Trainer(cfg, device="cpu")
    restored = fresh.load_checkpoint(path, fresh.init_state(steps_per_epoch=10, seed=7))
    assert restored.step == 2 and restored.scheduler.last_epoch == 2
    assert restored.optimizer.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.25)
    nxt = make_batch(seed=3)
    a, _ = trainer.train_step(state, trainer.to_device(nxt), 1)
    b, _ = fresh.train_step(restored, fresh.to_device(nxt), 1)
    for name, value in a.model.state_dict().items():
        assert torch.equal(value, b.model.state_dict()[name]), name

    # a checkpoint of the JAX Trainer (optax state, no torch optimizer) loads too
    jt = JaxTrainer(small_config(JaxConfig, save_dir=str(tmp_path / "jax")))
    jstate = jt.init_state(batch, steps_per_epoch=10, seed=0)
    jpath = jt.save_checkpoint(jstate, "best")
    loaded = fresh.load_checkpoint(jpath, fresh.init_state(steps_per_epoch=10, seed=7))
    ref = from_flax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for name, value in ref.items():
        assert torch.equal(loaded.model.state_dict()[name], value), name


def test_msgpack_writer_matches_flax(rng):
    """What ``flax_msgpack.dumps`` writes, flax restores, and the port's own
    reader reads back; ``to_flax_variables`` inverts ``from_flax_variables``."""
    tree = {"params": {"a": {"kernel": rng.normal(size=(3, 300)).astype(np.float32),
                             "bias": np.zeros(3, np.float32)}},
            "step": np.asarray(7, np.int32),
            "extra": {"n": 5, "x": -1.5, "flag": True, "none": None, "name": "adam" * 20,
                      "list": [1, [2.5, "s"]], "big": np.arange(70000, dtype=np.int64)}}
    data = flax_msgpack.dumps(tree)
    for back in (serialization.msgpack_restore(data), flax_msgpack.loads(data)):
        np.testing.assert_array_equal(back["params"]["a"]["kernel"], tree["params"]["a"]["kernel"])
        assert back["params"]["a"]["kernel"].dtype == np.float32
        assert int(back["step"]) == 7 and back["step"].shape == ()
        assert back["extra"]["list"] == [1, [2.5, "s"]] and back["extra"]["name"] == "adam" * 20
        assert back["extra"]["flag"] is True and back["extra"]["none"] is None
        np.testing.assert_array_equal(back["extra"]["big"], tree["extra"]["big"])
    with pytest.raises(TypeError):
        flax_msgpack.dumps({1: 2})
    state = Trainer(small_config(Config), device="cpu").init_state(10).model.state_dict()
    back = from_flax_variables(to_flax_variables(state))
    assert set(back) == set(state)
    for name, value in state.items():
        assert torch.equal(back[name], value), name


def test_loader_matches_jax_loader():
    """The same batches in the same order, shuffled with the same seed, padded
    to the 1024 bucket with a mask; ``drop_last`` as the reference's loop."""
    kw = dict(num_pairs=7, num_corr=300, seed=5)
    a = JaxLoader(JaxSyntheticPairDataset(**kw), 2, shuffle=True, num_workers=2, seed=3)
    b = Loader(SyntheticPairDataset(**kw), 2, shuffle=True, num_workers=2, seed=3)
    assert len(a) == len(b) == 3
    for _ in range(2):  # two epochs: the shuffle advances the same way
        batches_a, batches_b = list(a), list(b)
        assert len(batches_b) == 3
        for x, y in zip(batches_a, batches_b):
            assert x.keys() == y.keys()
            for key in x:
                np.testing.assert_array_equal(x[key], y[key])
    assert batches_b[0]["corr_pos"].shape == (2, 512, 6) and batches_b[0]["mask"].sum() == 600
    assert len(Loader(SyntheticPairDataset(**kw), 2, drop_last=False)) == 4


def test_train_synthetic_tool_runs_on_the_cpu(tmp_path, capsys):
    """The tool end to end at full width and depth but few, small batches,
    fused: evaluate, one epoch, best snapshot, the RESULT line; the snapshot
    registers a pair."""
    snap = str(tmp_path / "snap")
    res0, res1 = train_synthetic.main([
        "--device", "cpu", "--epochs", "1", "--iters", "3", "--num_pairs", "12",
        "--num_node", "100", "--batch_size", "2",
        "--fused_attention", "true", "--fused_sm_loss", "true", "--snapshot_dir", snap])
    text = capsys.readouterr().out
    assert "RESULT class_loss" in text and "Evaluation: Epoch 1" in text
    assert all(np.isfinite(v) for v in res1.values()) and res0.keys() == res1.keys()
    assert os.path.exists(os.path.join(snap, "models", "model_best.pkl"))
    assert os.path.exists(os.path.join(snap, "tb", "events.jsonl"))
    cfg = Config.load(os.path.join(snap, "config.json"))
    assert cfg.fused_attention and cfg.fused_sm_loss and cfg.num_node == 100
    model = load_pretrained(snap, device="cpu")
    ex = SyntheticPairDataset(num_pairs=1, num_corr=128, seed=2)[0]
    out = register(ex["corr_pos"], ex["src_keypts"], ex["tgt_keypts"], model=model, device="cpu")
    assert bool(torch.isfinite(out.final_trans).all())
