"""Meshes, several processes, and the sequence-parallel encoder (counterpart
of ``pointdsc_tpu/parallel``). JAX's ``batch_sharding`` and
``replicated_sharding`` have no counterpart: parallel/mesh.py says why."""

from pointdsc_tpu_torch.parallel.mesh import make_mesh, shard_batch
from pointdsc_tpu_torch.parallel.seq_parallel import (
    sp_encode,
    sp_encode_fused,
    sp_testing_forward,
)
