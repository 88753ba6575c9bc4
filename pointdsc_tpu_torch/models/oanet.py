"""Order-Aware Net, the ablation architecture (PyTorch counterpart of
``pointdsc_tpu/models/oanet.py``), channels-last [B, N, C].

Differentiable pooling to a small set of cluster slots (soft assignments),
order-aware filters with a spatial correlation layer over the cluster axis,
unpooling, and an inlier-logit head; then weights = relu(tanh(logits)) and a
weighted Procrustes fit give the transform.

Submodule names follow the flax tree (``l1_1``, ``down1``, ``oa_0``,
``Dense_2``, ``MaskedBatchNorm_1``, ...), so ``compat/weights.py::
from_flax_variables`` maps a flax OANet checkpoint onto the state dict and
``from_torch_oanet_state_dict`` a reference one onto the flax tree.
``module.training`` is the reference's ``train``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.models.blocks import ContextNorm, MaskedBatchNorm
from pointdsc_tpu_torch.ops.procrustes import weighted_procrustes

_NEG_INF = -1e9


def _pool_embedding(block, x, mask):
    """ContextNorm -> BatchNorm -> ReLU -> Dense(num_clusters): [B, N, K]."""
    h = F.relu(block.MaskedBatchNorm_0(block.ContextNorm_0(x, mask), mask))
    return block.Dense_0(h)


class DiffPool(nn.Module):
    """Soft-pool N correspondences into ``num_clusters`` slots: S = softmax
    over N of a learned embedding; out = S^T x, [B, K, C]."""

    def __init__(self, num_channels: int, num_clusters: int = 10):
        super().__init__()
        self.ContextNorm_0 = ContextNorm()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(num_channels)
        self.Dense_0 = nn.Linear(num_channels, num_clusters)

    def forward(self, x, mask=None):
        embed = _pool_embedding(self, x, mask)
        if mask is not None:
            embed = torch.where(mask[..., None], embed, torch.full_like(embed, _NEG_INF))
        S = torch.softmax(embed, dim=-2)  # over correspondences
        return torch.einsum("bnk,bnc->bkc", S, x)


class DiffUnpool(nn.Module):
    """Distribute cluster features back to correspondences: S = softmax over
    clusters; out = S x_down, [B, N, C]."""

    def __init__(self, num_channels: int, num_clusters: int = 10):
        super().__init__()
        self.ContextNorm_0 = ContextNorm()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(num_channels)
        self.Dense_0 = nn.Linear(num_channels, num_clusters)

    def forward(self, x_up, x_down, mask=None):
        S = torch.softmax(_pool_embedding(self, x_up, mask), dim=-1)  # over clusters
        return torch.einsum("bnk,bkc->bnc", S, x_down)


class OAFilter(nn.Module):
    """Order-aware filter over the cluster axis of [B, K, C]: channel MLP ->
    spatial correlation layer (a Dense across the K slots, batch-normalised
    over the swapped [B, out_c, K]) -> channel MLP, residual."""

    def __init__(self, num_channels: int, num_clusters: int, out_channels: int | None = None):
        super().__init__()
        out_c = out_channels or num_channels
        self.ContextNorm_0 = ContextNorm()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(num_channels)
        self.Dense_0 = nn.Linear(num_channels, out_c)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(num_clusters)
        self.Dense_1 = nn.Linear(num_clusters, num_clusters)
        self.ContextNorm_1 = ContextNorm()
        self.MaskedBatchNorm_2 = MaskedBatchNorm(out_c)
        self.Dense_2 = nn.Linear(out_c, out_c)
        self.Dense_3 = nn.Linear(num_channels, out_c) if out_c != num_channels else None

    def forward(self, x):
        h = self.Dense_0(F.relu(self.MaskedBatchNorm_0(self.ContextNorm_0(x))))
        s = F.relu(self.MaskedBatchNorm_1(h.transpose(-1, -2)))  # [B, out_c, K]
        h = h + self.Dense_1(s).transpose(-1, -2)
        h2 = self.Dense_2(F.relu(self.MaskedBatchNorm_2(self.ContextNorm_1(h))))
        return h2 + (x if self.Dense_3 is None else self.Dense_3(x))


class PointCNStack(nn.Module):
    """Dense, then ``num_layers`` x (Dense + ContextNorm (unbiased, as the
    reference's ``torch.var``) + BatchNorm + ReLU)."""

    def __init__(self, in_dim: int, num_channels: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        self.Dense_0 = nn.Linear(in_dim, num_channels)
        for j in range(num_layers):
            setattr(self, f"Dense_{j + 1}", nn.Linear(num_channels, num_channels))
            setattr(self, f"ContextNorm_{j}", ContextNorm(unbiased=True))
            setattr(self, f"MaskedBatchNorm_{j}", MaskedBatchNorm(num_channels))

    def forward(self, x, mask=None):
        x = self.Dense_0(x)
        for j in range(self.num_layers):
            x = getattr(self, f"Dense_{j + 1}")(x)
            x = getattr(self, f"ContextNorm_{j}")(x, mask)
            x = F.relu(getattr(self, f"MaskedBatchNorm_{j}")(x, mask))
        return x


class OANet(nn.Module):
    """OANet with the logit head and a weighted Procrustes fit. Random
    weights come from ``generator``; a new model is in eval mode."""

    def __init__(self, in_dim: int = 6, num_layers: int = 6, num_channels: int = 128,
                 num_clusters: int = 10, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        half = num_layers // 2
        self.half = half
        self.l1_1 = PointCNStack(in_dim, num_channels, half)
        self.down1 = DiffPool(num_channels, num_clusters)
        for i in range(half):
            setattr(self, f"oa_{i}", OAFilter(num_channels, num_clusters))
        self.up1 = DiffUnpool(num_channels, num_clusters)
        self.l1_2 = PointCNStack(2 * num_channels, num_channels, half - 1)
        self.output = nn.Linear(num_channels, 1)
        if generator is not None:
            self._init_random(generator)
        self.to(dev).eval()

    @torch.no_grad()
    def _init_random(self, generator: torch.Generator) -> None:
        """Kernels normal with variance 1 / fan_in (flax Dense's LeCun scale,
        not its truncated draw), zero biases, from the caller's generator."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                                 / fan_in ** 0.5)
                mod.bias.zero_()

    @full_f32_matmul()
    def forward(self, corr_pos, src_keypts, tgt_keypts, mask=None, testing: bool = False):
        """corr_pos [B, N, in_dim], src/tgt [B, N, 3], mask [B, N] bool ->
        {"final_trans" [B, 4, 4], "final_labels" [B, N] logits (-1e9 where
        masked), "M": None}. ``testing`` changes nothing (the reference's
        signature)."""
        b, n, _ = corr_pos.shape
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=corr_pos.device)
        x1 = self.l1_1(corr_pos, mask)
        x2 = self.down1(x1, mask)
        for i in range(self.half):
            x2 = getattr(self, f"oa_{i}")(x2)
        x_up = self.up1(x1, x2, mask)
        out = self.l1_2(torch.cat([x1, x_up], dim=-1), mask)
        logits = self.output(out)[..., 0]
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
        weights = F.relu(torch.tanh(logits)) * mask
        trans = weighted_procrustes(src_keypts, tgt_keypts, weights)
        return {"final_trans": trans, "final_labels": logits, "M": None}
