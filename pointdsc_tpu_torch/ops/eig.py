"""Leading-eigenvector power iteration, the Neural Spectral Matching core
(PyTorch counterpart of ``pointdsc_tpu/ops/eig.py:16-72``)."""

from __future__ import annotations

import torch


def power_iteration(M: torch.Tensor, num_iters: int = 10, eps: float = 1e-6) -> torch.Tensor:
    """Leading eigenvector of batched symmetric nonnegative M [..., n, n].

    A fixed ``num_iters`` iterations with the reference's v / (||v|| + eps)
    normalisation and no early exit, as in the JAX package. Returns [..., n].
    """
    v = torch.ones(M.shape[:-1] + (1,), dtype=M.dtype, device=M.device)
    for _ in range(num_iters):
        w = M @ v
        norm = torch.sqrt(torch.sum(w * w, dim=-2, keepdim=True) + 1e-30)
        v = w / (norm + eps)
    return v[..., 0]
