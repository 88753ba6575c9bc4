"""The port's multi-process layer (``pointdsc_tpu_torch/parallel/
distributed.py``) and its data-parallel Trainer, on two gloo processes.

The workers are started as ``tests/test_multihost.py`` starts its
``jax.distributed`` ones: two subprocesses, a free port on 127.0.0.1, a
timeout. They check ``initialize``, ``process_shard`` (against JAX's),
``all_gather_rows`` and an all-reduce, then run Trainer steps (2 layers,
C = 32, N = 128, Adam) as two ranks, from the weights of JAX's
``Trainer(num_devices=2)`` on two of the suite's virtual devices. The ranks
are held to the one-process port step on the same global batches and to
JAX's sharded step:

* against the one-process step: losses rtol 1e-5, gradients rtol 1e-4 +
  atol 1e-6 (the global sums add the two shards' partial sums, another
  order), BatchNorm running statistics atol 1e-6 + rtol 1e-5; after two
  Adam steps the parameters within 2 lr per step everywhere (a gradient of
  rounding noise, ``NOISE_GRADIENT``, is normalised by Adam to a full step
  in either direction) and 99% of the entries within 1e-6 for every
  parameter above the noise; a running mean, which follows the Dense bias in
  front of its BatchNorm, within 5 lr per step taken before it;
* against JAX: the rules of ``tests/test_torch_trainer.py``.

Both ranks must end with equal weights. A global batch of 3 (the world of 2
does not divide it) runs on rank 0 alone, as JAX runs it on one device; a
NaN label in rank 1's half skips the step on both ranks; a non-finite
gradient on rank 1 alone makes both ranks' guard refuse the step.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.parallel.distributed import process_shard as jax_process_shard
from pointdsc_tpu.parallel.mesh import shard_batch
from pointdsc_tpu.train.config import Config as JaxConfig
from pointdsc_tpu.train.trainer import Trainer as JaxTrainer
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.train.config import Config
from pointdsc_tpu_torch.train.trainer import Trainer
from tests.test_torch_train_model import make_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layers=2, num_channels=32, k=12, ratio=0.2, num_node=112, tboard_dir="",
             verbose=False, optimizer="ADAM", lr=1e-3, weight_decay=1e-3)
NOISE_GRADIENT = 1e-5
CASES = {  # name: (fused, global batch size)
    "dense": (False, 4),
    "fused": (True, 4),
    "odd": (False, 3),
    "nan": (False, 4),
}

WORKER = r"""
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
from pointdsc_tpu_torch.parallel import distributed as D
from pointdsc_tpu_torch.train.config import Config
from pointdsc_tpu_torch.train.trainer import Trainer

rank, port, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
D.initialize("127.0.0.1:" + port, 2, rank, device="cpu")
res = {"shard": D.process_shard(10),
       "gathered": D.all_gather_rows(np.array([rank, 10.0 * rank], np.float32)),
       "sum": D.global_sum(torch.tensor([rank + 1.0]), D.global_mesh()).numpy(),
       "world": np.asarray(D.global_mesh() is torch.distributed.group.WORLD)}
blob = torch.load(data, weights_only=False)
for case, (fused, bs) in blob["cases"].items():
    cfg = Config(**blob["small"], batch_size=bs, fused_attention=fused, fused_sm_loss=fused)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(steps_per_epoch=10, seed=0)
    state.model.load_state_dict(blob["weights"])
    res[case + ".active"] = np.asarray(trainer.active)
    if not trainer.active:
        continue
    for i, batch in enumerate(blob["batches"][case]):
        state, metrics = trainer.train_step(state, trainer.to_device(batch), 1)
        for k, v in metrics.items():
            res[f"{case}.{i}.m.{k}"] = np.asarray(float(v))
        for name, p in state.model.named_parameters():
            res[f"{case}.{i}.g.{name}"] = p.grad.numpy().copy()
        for name, v in state.model.state_dict().items():
            res[f"{case}.{i}.sd.{name}"] = v.numpy().copy()

# the guard alone: a non-finite gradient on rank 1 only
cfg = Config(**blob["small"], batch_size=4)
trainer = Trainer(cfg, device="cpu")
state = trainer.init_state(steps_per_epoch=10, seed=0)
params = list(state.model.parameters())
for p in params:
    p.grad = torch.zeros_like(p)
if rank == 1:
    params[3].grad[0] = float("inf")
res["guard"] = np.asarray(bool(trainer.grads_finite(params)))
np.savez(out + f".{rank}.npz", **res)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _batches():
    """Two global batches of 4 pairs a case (3 for "odd"); "nan" puts a NaN
    label in the first batch's last pair, rank 1's half."""
    four = [{k: np.concatenate([a[k], b[k]]) for k in a}
            for a, b in ((make_batch(seed=1), make_batch(seed=2)),
                         (make_batch(seed=3), make_batch(seed=4)))]
    out = {case: [{k: v[:bs].copy() for k, v in b.items()} for b in four]
           for case, (_, bs) in CASES.items()}
    out["nan"][0]["gt_labels"][3, 5] = np.nan
    return out


def _one_process(weights, case, batches):
    """The one-process port steps of a case: per step (metrics, grads,
    state dict)."""
    fused, bs = CASES[case]
    cfg = Config(**SMALL, batch_size=bs, fused_attention=fused, fused_sm_loss=fused)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(steps_per_epoch=10, seed=0)
    state.model.load_state_dict(weights)
    steps = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' count: the same reduction orders
    try:
        for batch in batches:
            state, metrics = trainer.train_step(state, trainer.to_device(batch), 1)
            steps.append(({k: float(v) for k, v in metrics.items()},
                          {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()},
                          {n: v.numpy().copy() for n, v in state.model.state_dict().items()}))
    finally:
        torch.set_num_threads(threads)
    return steps


def _hold_params(got, ref, taken, noisy, lr, tight):
    for name, value in ref.items():
        a, b = got[name], value
        if "running_" in name:
            continue
        assert np.abs(a - b).max() <= 2 * lr * taken + 1e-6, name
        if name not in noisy:
            assert (np.abs(a - b) <= tight).mean() >= 0.99, name


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's initial variables as a port state dict, the batches, the two
    ranks' results, JAX's sharded steps of the dense and the fused case)."""
    tmp = tmp_path_factory.mktemp("dist")
    batches = _batches()
    jax_steps = {}
    weights = None
    for case in ("dense", "fused"):
        fused, bs = CASES[case]
        jcfg = JaxConfig(**SMALL, batch_size=bs, fused_attention=fused, fused_sm_loss=fused,
                         num_devices=2)
        jt = JaxTrainer(jcfg)
        assert jt.mesh.devices.size == 2
        jstate = jt.init_state(batches[case][0], steps_per_epoch=10, seed=0)
        jt.build_steps()
        if weights is None:
            weights = from_flax_variables(jax.tree_util.tree_map(
                np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
        steps = []
        for batch in batches[case]:
            jstate, jm = jt._train_step(jstate, shard_batch(batch, jt.mesh),
                                        jnp.asarray(1, jnp.int32))
            steps.append(({k: float(v) for k, v in jm.items()}, from_flax_variables(
                jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                                    "batch_stats": jstate.batch_stats}))))
        jax_steps[case] = steps

    data = str(tmp / "data.pt")
    torch.save({"weights": weights, "batches": batches, "cases": CASES, "small": SMALL}, data)
    script = tmp / "worker.py"
    script.write_text(WORKER % {"repo": REPO})
    out = str(tmp / "result")
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), port, data, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for rank in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(out + f".{rank}.npz")) for rank in range(2)]
    return weights, batches, ranks, jax_steps


def test_collectives(runs):
    """``initialize`` over gloo, the world as the global mesh,
    ``process_shard`` equal to JAX's strided split, ``all_gather_rows`` in
    rank order on both ranks, and a summing all-reduce."""
    _, _, ranks, _ = runs
    for rank, res in enumerate(ranks):
        assert bool(res["world"])
        np.testing.assert_array_equal(res["shard"], jax_process_shard(10, rank, 2))
        np.testing.assert_array_equal(res["gathered"], [[0.0, 0.0], [1.0, 10.0]])
        np.testing.assert_array_equal(res["sum"], [3.0])


@pytest.mark.parametrize("case", ["dense", "fused"])
def test_two_rank_steps_match_one_process_and_jax(runs, case):
    """Two Adam steps of the dense and of the fused Trainer as two ranks
    against the one-process port steps and JAX's ``Trainer(num_devices=2)``
    (the module's tolerances)."""
    weights, batches, ranks, jax_steps = runs
    lr = SMALL["lr"]
    ref = _one_process(weights, case, batches[case])
    noisy = set()
    for i, (metrics, grads, sd) in enumerate(ref):
        noisy |= {n for n, g in grads.items() if np.abs(g).max() < NOISE_GRADIENT}
        jm, jsd = jax_steps[case][i]
        for rank, res in enumerate(ranks):
            assert bool(res[case + ".active"])
            assert float(res[f"{case}.{i}.m.grad_finite"]) == 1.0
            for key in ("loss", "class_loss", "sm_loss", "reg_recall", "precision"):
                got = float(res[f"{case}.{i}.m.{key}"])
                np.testing.assert_allclose(got, metrics[key], rtol=1e-5, atol=1e-7,
                                           err_msg=f"rank {rank} step {i} {key}")
            np.testing.assert_allclose(float(res[f"{case}.{i}.m.loss"]), jm["loss"], rtol=1e-4)
            for name, g in grads.items():
                np.testing.assert_allclose(res[f"{case}.{i}.g.{name}"], g, rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {rank} step {i} grad {name}")
            got = {n: res[f"{case}.{i}.sd.{n}"] for n in sd}
            for name in sd:
                # a running mean follows the Dense bias in front of its
                # BatchNorm, which a noise gradient steps by up to lr either
                # way: 5 lr per step taken
                if "running_mean" in name and i > 0:
                    tols = [dict(atol=5 * lr * i)] * 2
                else:
                    tols = [dict(atol=1e-6, rtol=1e-5), dict(atol=1e-5, rtol=1e-4)]
                if "running_" in name:
                    np.testing.assert_allclose(got[name], sd[name], **tols[0],
                                               err_msg=f"rank {rank} step {i} {name}")
                    np.testing.assert_allclose(got[name], jsd[name].numpy(), **tols[1],
                                               err_msg=f"rank {rank} step {i} {name}")
            _hold_params(got, sd, i + 1, noisy, lr, 1e-6)
            _hold_params(got, {n: v.numpy() for n, v in jsd.items()}, i + 1, noisy, lr, 1e-5)
    for name in ref[-1][2]:  # the replicas stayed together
        key = f"{case}.{len(ref) - 1}.sd.{name}"
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_batch_the_world_does_not_divide(runs):
    """A global batch of 3 on a world of 2: JAX's rule takes one device, so
    rank 0 trains alone on the whole batch (rank 1 holds no samples) and
    equals the one-process steps (losses rtol 1e-6, gradients and weights
    atol 1e-6: a group of one sums nothing, only the batch means are
    formed as a sum over the count)."""
    weights, batches, ranks, _ = runs
    assert bool(ranks[0]["odd.active"]) and not bool(ranks[1]["odd.active"])
    ref = _one_process(weights, "odd", batches["odd"])
    for i, (metrics, grads, sd) in enumerate(ref):
        np.testing.assert_allclose(float(ranks[0][f"odd.{i}.m.loss"]), metrics["loss"],
                                   rtol=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(ranks[0][f"odd.{i}.g.{name}"], g, rtol=1e-5, atol=1e-6)
        for name, v in sd.items():
            np.testing.assert_allclose(ranks[0][f"odd.{i}.sd.{name}"], v, rtol=1e-5, atol=1e-6)


def test_non_finite_gradient_skips_on_every_rank(runs):
    """A NaN label in rank 1's half of the first batch: both ranks skip the
    step (``grad_finite`` 0, the parameters as loaded), as the one-process
    step does, then take the second; and the guard alone, fed an infinite
    gradient entry on rank 1 only, refuses the step on both ranks."""
    weights, batches, ranks, _ = runs
    ref = _one_process(weights, "nan", batches["nan"])
    assert ref[0][0]["grad_finite"] == 0.0 and ref[1][0]["grad_finite"] == 1.0
    for res in ranks:
        assert float(res["nan.0.m.grad_finite"]) == 0.0
        assert float(res["nan.1.m.grad_finite"]) == 1.0
        for name, v in weights.items():
            if "running_" not in name:
                np.testing.assert_array_equal(res[f"nan.0.sd.{name}"], v.numpy())
        assert not bool(res["guard"])
