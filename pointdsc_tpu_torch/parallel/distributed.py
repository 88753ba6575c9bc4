"""Several processes over ``torch.distributed`` (PyTorch counterpart of
``pointdsc_tpu/parallel/distributed.py``).

  * ``initialize`` joins the default process group over ``tcp://``: NCCL
    for ``device="cuda"``, gloo for ``device="cpu"``. The caller names the
    device; nothing probes for a backend or falls back to another.
  * ``global_mesh`` is the world, the default group.
  * ``process_shard`` is the JAX package's strided split of a pair list, so
    each process loads only its own pairs and the pairs' difficulty stays
    balanced.
  * ``all_gather_rows`` gathers equal-shaped rows (stats rows) from every
    process onto every process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device: str | torch.device = "cuda") -> None:
    """Join the default process group of ``num_processes`` processes as rank
    ``process_id``, rendezvous at ``coordinator_address`` ('host:port'). The
    backend follows ``device``: NCCL for a CUDA device (which then becomes
    the process's current device), gloo for the CPU."""
    dev = torch.device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; initialize(device='cpu') runs gloo")
        torch.cuda.set_device(dev if dev.index is not None else torch.device("cuda", 0))
    dist.init_process_group(_BACKENDS[dev.type], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_mesh():
    """The world: the default process group (``None`` for torch.distributed
    calls), once ``initialize`` has run."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call initialize() first")
    return dist.group.WORLD


def process_shard(num_items: int, process_index: int | None = None,
                  process_count: int | None = None) -> np.ndarray:
    """Indices of the pair list this process loads: a strided split."""
    initialized = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if initialized else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if initialized else 1) if process_count is None else process_count
    return np.arange(pi, num_items, pc)


def all_gather_rows(local_rows) -> np.ndarray:
    """Every process's ``local_rows`` (one shape on every process), stacked
    in rank order on every process: [world, *shape]. The rows travel on the
    backend's device (the current CUDA device under NCCL)."""
    rows = torch.as_tensor(np.asarray(local_rows))
    if dist.get_backend() == "nccl":
        rows = rows.to(torch.device("cuda", torch.cuda.current_device()))
    out = [torch.empty_like(rows) for _ in range(dist.get_world_size())]
    dist.all_gather(out, rows.contiguous())
    return torch.stack(out).cpu().numpy()


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``group``, autograd-aware: the
    gradient of the result reaches every process's ``x`` (the backward is
    the same all-reduce). Without a group, ``x`` itself. The data-parallel
    Trainer's global-batch sums (models/blocks.py, train/losses.py) go
    through it."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def group_size(group=None) -> int:
    """Processes of ``group``; 1 without one."""
    return 1 if group is None else dist.get_world_size(group)
