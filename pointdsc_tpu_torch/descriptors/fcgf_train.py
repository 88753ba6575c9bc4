"""VoxelFCGF training: the hardest-contrastive loss and a train step over
pairs of augmented views (PyTorch counterpart of
``pointdsc_tpu/descriptors/fcgf_train.py``):

    L = mean_pos  max(0, ||f0_i - f1_i|| - m_pos)^2
      + 0.5 * (mean max(0, m_neg - hardest_neg_0)^2 + mean max(0, m_neg - hardest_neg_1)^2)

with the hardest negatives mined within the batch (the true match and masked
columns excluded).
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch._device import full_f32_matmul
from pointdsc_tpu_torch.descriptors.fcgf import take_voxels


def _max0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the reference's gradient at x == 0 (a half, as
    ``torch.maximum``; ``clamp`` would pass all of it). The squared distance
    of two equal descriptors rounds to exactly 0, and the sqrt's slope of
    5e5 there makes the half count."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def hardest_contrastive_loss(f0: torch.Tensor, f1: torch.Tensor, pos_margin: float = 0.1,
                             neg_margin: float = 1.4, mask: torch.Tensor | None = None):
    """Matched descriptor pairs f0, f1 [N, C] (rows of ``mask`` [N] bool
    valid) -> (loss, metrics dict of 0-d tensors)."""
    n = f0.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=f0.device)
    m = mask.to(f0.dtype)
    count = torch.clamp(torch.sum(m), min=1.0)

    pos_d = torch.sqrt(torch.sum((f0 - f1) ** 2, dim=-1) + 1e-12)
    pos_loss = torch.sum(_max0(pos_d - pos_margin) ** 2 * m) / count

    d01 = torch.sqrt(_max0(torch.sum(f0 * f0, -1)[:, None] + torch.sum(f1 * f1, -1)[None, :]
                           - 2.0 * f0 @ f1.T) + 1e-12)
    eye = torch.eye(n, dtype=torch.bool, device=f0.device)
    d01 = torch.where(eye | ~mask[None, :], torch.full_like(d01, 1e6), d01)
    hardest0 = torch.amin(d01, dim=1)
    hardest1 = torch.amin(d01, dim=0)
    neg0 = torch.sum(_max0(neg_margin - hardest0) ** 2 * m) / count
    neg1 = torch.sum(_max0(neg_margin - hardest1) ** 2 * m) / count
    neg_loss = 0.5 * (neg0 + neg1)
    return pos_loss + neg_loss, {
        "pos_loss": pos_loss,
        "neg_loss": neg_loss,
        "pos_dist": torch.sum(pos_d * m) / count,
        "neg_dist": torch.sum(hardest0 * m) / count,
    }


def make_fcgf_train_step(model, optimizer: torch.optim.Optimizer):
    """A step over paired occupancy grids [1, 1, D, D, D] and matched voxel
    indices [M, 3] with their validity [M]: both views through the model in
    training mode one after the other (the second's BatchNorm statistics
    advance from the first's), the loss, one ``optimizer`` step (Adam at
    optax's defaults: ``torch.optim.Adam(params, lr)``). Returns the
    metrics, ``loss`` among them, detached."""

    def step(occ0, occ1, idx0, idx1, mask):
        model.train()
        with full_f32_matmul():
            g0 = model(occ0)
            g1 = model(occ1)
            loss, metrics = hardest_contrastive_loss(take_voxels(g0[0], idx0),
                                                     take_voxels(g1[0], idx1),
                                                     mask=mask.to(g0.device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    return step
