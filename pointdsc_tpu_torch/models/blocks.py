"""Encoder blocks, eval mode, channels-last [B, N, C] (PyTorch counterparts
of ``pointdsc_tpu/models/blocks.py:31-80,148-166,254-386``).

Submodule names follow the flax parameter tree (``PointCN_layer_{i}``,
``projection_q``, ``fc_message_bn0``, ...) so that a flax checkpoint maps
onto the state dict key by key (compat/weights.py).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

_NEG_INF = -1e9


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (batch, num_corr) in eval mode: running statistics,
    eps 1e-5, affine. Masking matters only for training statistics, which
    the port does not compute yet, so eval mode needs no mask."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight / torch.sqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * a
        return x * a + b


class PointCNLayer(nn.Module):
    """Dense + BatchNorm + ReLU (one PointCN step)."""

    def __init__(self, in_features: int, num_channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, num_channels)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(num_channels)

    def forward(self, x):
        return F.relu(self.MaskedBatchNorm_0(self.Dense_0(x)))


def dense_sc_attention(q, k, v, compat, mask=None):
    """softmax(compat * q k^T / sqrt(C) + key mask) v over a materialised
    [B, N, N] compat matrix (the reference's attention, single head)."""
    c = q.shape[-1]
    logits = torch.einsum("bnc,bmc->bnm", q, k) / (c ** 0.5)
    scores = compat * logits
    if mask is not None:
        scores = torch.where(mask[:, None, :], scores, torch.full_like(scores, _NEG_INF))
    weight = torch.softmax(scores, dim=-1)
    return torch.einsum("bnm,bmc->bnc", weight, v)


class NonLocalBlock(nn.Module):
    """Spatial-consistency-modulated single-head attention, message MLP
    (C -> C/2 -> C/2 -> C with BN + ReLU) and residual.

    ``attention_fn(q, k, v, mask)`` replaces the dense attention over the
    materialised compat matrix (the fused path's cached-compat kernel)."""

    def __init__(self, num_channels: int):
        super().__init__()
        c = num_channels
        self.projection_q = nn.Linear(c, c)
        self.projection_k = nn.Linear(c, c)
        self.projection_v = nn.Linear(c, c)
        self.fc_message_0 = nn.Linear(c, c // 2)
        self.fc_message_bn0 = MaskedBatchNorm(c // 2)
        self.fc_message_1 = nn.Linear(c // 2, c // 2)
        self.fc_message_bn1 = MaskedBatchNorm(c // 2)
        self.fc_message_2 = nn.Linear(c // 2, c)

    def forward(self, feat, compat, mask=None, attention_fn: Callable | None = None):
        q = self.projection_q(feat)
        k = self.projection_k(feat)
        v = self.projection_v(feat)
        if attention_fn is not None:
            message = attention_fn(q, k, v, mask)
        else:
            message = dense_sc_attention(q, k, v, compat, mask)
        message = F.relu(self.fc_message_bn0(self.fc_message_0(message)))
        message = F.relu(self.fc_message_bn1(self.fc_message_1(message)))
        message = self.fc_message_2(message)
        return feat + message


class NonLocalNet(nn.Module):
    """Input lift + num_layers x (PointCN -> NonLocal); the compat matrix (or
    the attention_fn closing over its int8 cache) is shared by all layers."""

    def __init__(self, in_dim: int = 6, num_layers: int = 12, num_channels: int = 128):
        super().__init__()
        self.num_layers = num_layers
        self.layer0 = nn.Linear(in_dim, num_channels)
        for i in range(num_layers):
            setattr(self, f"PointCN_layer_{i}", PointCNLayer(num_channels, num_channels))
            setattr(self, f"NonLocal_layer_{i}", NonLocalBlock(num_channels))

    def forward(self, corr_feat, compat, mask=None, attention_fn=None):
        x = self.layer0(corr_feat)
        for i in range(self.num_layers):
            x = getattr(self, f"PointCN_layer_{i}")(x)
            x = getattr(self, f"NonLocal_layer_{i}")(x, compat, mask=mask,
                                                     attention_fn=attention_fn)
        return x
