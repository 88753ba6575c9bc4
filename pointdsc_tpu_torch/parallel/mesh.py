"""Device meshes (PyTorch counterpart of ``pointdsc_tpu/parallel/mesh.py``).

A mesh is an ordered list of ``torch.device``s along one axis. It carries
the two layouts the JAX package shards over: the pair batch of sharded
evaluation (eval/runner.py::run_dataset_sharded, a model replica on each
distinct device) and the correspondence rows of the sequence-parallel
encoder (parallel/seq_parallel.py, one row shard a mesh entry).

A mesh may name one device several times: ``[cpu] * D`` is the CPU
counterpart of JAX's D virtual CPU devices, and ``[cuda:0] * D`` runs D
shards on one card. JAX's ``batch_sharding`` and ``replicated_sharding``
describe how XLA lays an array over a mesh; eager PyTorch has no such
object (a tensor lives on one device, and the caller places each shard), so
they have no counterpart here.
"""

from __future__ import annotations

import torch


def canonical(device) -> torch.device:
    """``device`` with its index: a CUDA device named without one is the
    current one (``cuda`` and ``cuda:0`` are then the same entry)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(num_devices: int = 0, devices=None) -> list[torch.device]:
    """The first ``num_devices`` visible CUDA devices (0: all of them), or
    the caller's explicit list of devices."""
    if devices is not None:
        mesh = [canonical(d) for d in devices]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[torch.device('cpu')] * D for a CPU mesh")
        mesh = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if num_devices:
            if num_devices > len(mesh):
                raise ValueError(f"{num_devices} devices asked for, {len(mesh)} visible")
            mesh = mesh[:num_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_batch(batch: dict, mesh) -> list[dict]:
    """Split every array of ``batch`` on axis 0 into ``len(mesh)`` equal
    shards, shard i as tensors on ``mesh[i]``. Axis 0 must divide the mesh."""
    d = len(mesh)
    sizes = {int(v.shape[0]) for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % d:
        raise ValueError(f"axis 0 of every array must be one size divisible by {d}: {sizes}")
    per = next(iter(sizes)) // d
    return [{key: torch.as_tensor(v)[i * per:(i + 1) * per].to(dev)
             for key, v in batch.items()} for i, dev in enumerate(mesh)]
