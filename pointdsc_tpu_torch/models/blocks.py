"""Encoder blocks, channels-last [B, N, C] (PyTorch counterparts
of ``pointdsc_tpu/models/blocks.py:31-80,148-166,254-386``).

Submodule names follow the flax parameter tree (``PointCN_layer_{i}``,
``projection_q``, ``fc_message_bn0``, ...) so that a flax checkpoint maps
onto the state dict key by key (compat/weights.py). The whole-layer hook
(``fused_layer_fn``) reads the same parameters raw, so the state dict is the
same whichever path runs.

``compute_dtype=torch.bfloat16`` is the JAX package's ``half_precision``:
each Dense casts its input, weight and bias to bf16 and returns bf16; a
BatchNorm computes its per-channel affine in f32 and applies it in its
input's dtype, so the activation chain stays bf16 from the first PointCN on.

In training mode (``module.training``) a BatchNorm normalises with the
statistics of the batch's valid entries and advances its running ones;
``mask`` reaches it through every block for that.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pointdsc_tpu_torch.utils.trace import span

_NEG_INF = -1e9


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (batch, num_corr) with a validity mask: eps 1e-5,
    affine, statistics in f32 whatever the input's type.

    Eval mode normalises with the running statistics. Training mode takes
    mean and variance over the valid entries only, the variance biased, and
    advances running = 0.9 * running + 0.1 * new with that same biased
    variance (``nn.BatchNorm1d`` would store the unbiased one).
    ``update_stats=False`` normalises without advancing them: the second run
    of a checkpointed layer.

    ``process_group`` (set by the data-parallel Trainer, ``set_process_group``)
    makes the training statistics those of the global batch, as JAX's
    sharded step computes them: the count, the sum and the centred sum of
    squares are summed over the group (autograd-aware), mean first, then the
    variance about it. Without a group nothing changes."""

    momentum = 0.9
    process_group = None

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                update_stats: bool = True) -> torch.Tensor:
        if self.training and self.process_group is not None:
            mean, var = self._global_stats(x.float(), mask)
            if update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                    self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        elif self.training:
            xs = x.float()
            if mask is None:
                mean = torch.mean(xs, dim=(0, 1))
                var = torch.mean((xs - mean) ** 2, dim=(0, 1))
            else:
                m = mask[..., None].float()
                count = torch.clamp(torch.sum(m), min=1.0)
                mean = torch.sum(xs * m, dim=(0, 1)) / count
                var = torch.sum(((xs - mean) ** 2) * m, dim=(0, 1)) / count
            if update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                    self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight / torch.sqrt(var + self.eps)
        b = self.bias - mean * a
        return x * a.to(x.dtype) + b.to(x.dtype)

    def raw(self):
        """(scale, bias, mean, var), the order of the JAX holder."""
        return self.weight, self.bias, self.running_mean, self.running_var

    def _global_stats(self, xs: torch.Tensor, mask: torch.Tensor | None):
        """(mean, biased variance) over the valid entries of every process's
        batch (``mask`` None: all entries)."""
        from pointdsc_tpu_torch.parallel.distributed import global_sum

        group = self.process_group
        m = (torch.ones(xs.shape[:2], dtype=xs.dtype, device=xs.device) if mask is None
             else mask.to(xs.dtype))[..., None]
        count = torch.clamp(global_sum(torch.sum(m).detach(), group), min=1.0)
        mean = global_sum(torch.sum(xs * m, dim=(0, 1)), group) / count
        var = global_sum(torch.sum(((xs - mean) ** 2) * m, dim=(0, 1)), group) / count
        return mean, var


def set_process_group(module: nn.Module, group) -> None:
    """Give every MaskedBatchNorm under ``module`` the process group over
    which its training statistics are summed (None: the local batch)."""
    for mod in module.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.process_group = group


class ContextNorm(nn.Module):
    """Per-set (instance) normalisation over the correspondence axis of
    [B, N, C], parameter-free: (x - mean) / sqrt(var + epsilon) over the
    valid entries of ``mask`` [B, N].

    The reference has two variance conventions: its ``ContextNormalization``
    takes ``torch.var``, unbiased (N - 1), and the ``InstanceNorm1d(eps=1e-3)``
    of the OANet pool and filter blocks the biased one (N); ``unbiased``
    selects."""

    def __init__(self, epsilon: float = 1e-3, unbiased: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.unbiased = unbiased

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is None:
            count = torch.tensor(float(x.shape[-2]), dtype=x.dtype, device=x.device)
            mean = torch.mean(x, dim=-2, keepdim=True)
            var = torch.mean((x - mean) ** 2, dim=-2, keepdim=True)
        else:
            m = mask[..., None].to(x.dtype)
            count = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
            mean = torch.sum(x * m, dim=-2, keepdim=True) / count
            var = torch.sum(((x - mean) ** 2) * m, dim=-2, keepdim=True) / count
        if self.unbiased:
            var = var * (count / torch.clamp(count - 1.0, min=1.0))
        return (x - mean) / torch.sqrt(var + self.epsilon)


def dense(layer: nn.Linear, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``layer(x)``; with ``compute_dtype`` the product and the bias add run
    and round in that type (two roundings, as flax's Dense with a dtype)."""
    if compute_dtype is None:
        return layer(x)
    return x.to(compute_dtype) @ layer.weight.to(compute_dtype).t() \
        + layer.bias.to(compute_dtype)


class PointCNLayer(nn.Module):
    """Dense + BatchNorm + ReLU (one PointCN step)."""

    def __init__(self, in_features: int, num_channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, num_channels)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(num_channels)

    def forward(self, x, mask=None, compute_dtype=None, update_stats=True):
        return F.relu(self.MaskedBatchNorm_0(dense(self.Dense_0, x, compute_dtype), mask,
                                             update_stats))

    def raw(self):
        """(w1, b1, bn1) for the whole-layer hook."""
        return self.Dense_0.weight, self.Dense_0.bias, self.MaskedBatchNorm_0.raw()


def dense_sc_attention(q, k, v, compat, mask=None):
    """softmax(compat * q k^T / sqrt(C) + key mask) v over a materialised
    [B, N, N] compat matrix (the reference's attention, single head)."""
    c = q.shape[-1]
    # bf16 streams (half precision): products of bf16 values summed in f32,
    # the weights rounded to v's type before the second product, as in JAX
    logits = torch.einsum("bnc,bmc->bnm", q.float(), k.float()) / (c ** 0.5)
    scores = compat * logits
    if mask is not None:
        scores = torch.where(mask[:, None, :], scores, torch.full_like(scores, _NEG_INF))
    weight = torch.softmax(scores, dim=-1).to(v.dtype).float()
    return torch.einsum("bnm,bmc->bnc", weight, v.float())


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

    def forward(self, feat, compat, mask=None, attention_fn: Callable | None = None,
                compute_dtype=None, update_stats=True):
        cdt = compute_dtype
        q = dense(self.projection_q, feat, cdt)
        k = dense(self.projection_k, feat, cdt)
        v = dense(self.projection_v, feat, cdt)
        with span("pointdsc.model.attention"):
            if attention_fn is not None:
                # the kernels take f32 or bf16 streams and return f32
                message = attention_fn(q, k, v, mask)
            else:
                message = dense_sc_attention(q, k, v, compat, mask)
        message = F.relu(self.fc_message_bn0(dense(self.fc_message_0, message, cdt), mask,
                                             update_stats))
        message = F.relu(self.fc_message_bn1(dense(self.fc_message_1, message, cdt), mask,
                                             update_stats))
        message = dense(self.fc_message_2, message, cdt)
        return feat + message.to(feat.dtype)

    def raw(self):
        """The 14 entries of the JAX holder ``_NonLocalParams``, Dense
        weights as PyTorch keeps them ([out, in])."""
        return (self.projection_q.weight, self.projection_q.bias,
                self.projection_k.weight, self.projection_k.bias,
                self.projection_v.weight, self.projection_v.bias,
                self.fc_message_0.weight, self.fc_message_0.bias, self.fc_message_bn0.raw(),
                self.fc_message_1.weight, self.fc_message_1.bias, self.fc_message_bn1.raw(),
                self.fc_message_2.weight, self.fc_message_2.bias)


class NonLocalNet(nn.Module):
    """Input lift + num_layers x (PointCN -> NonLocal); the compat matrix (or
    the attention_fn closing over its int8 cache) is shared by all layers.

    ``fused_layer_fn(x, pcn_params, nl_params)`` runs each pair as the
    whole-layer kernels (kernels/encoder_layer.py) on the layer's raw
    parameters; nothing between the layers reads a value back to the host.

    ``remat=True`` checkpoints each pair (``torch.utils.checkpoint``): its
    activations are recomputed in the backward pass, an attention kernel's
    forward then runs twice, and the BatchNorms advance their running
    statistics in the first run only."""

    def __init__(self, in_dim: int = 6, num_layers: int = 12, num_channels: int = 128):
        super().__init__()
        self.num_layers = num_layers
        self.layer0 = nn.Linear(in_dim, num_channels)
        for i in range(num_layers):
            setattr(self, f"PointCN_layer_{i}", PointCNLayer(num_channels, num_channels))
            setattr(self, f"NonLocal_layer_{i}", NonLocalBlock(num_channels))

    def layer_params(self, i: int):
        """(pcn_params, nl_params) of layer i, raw."""
        return (getattr(self, f"PointCN_layer_{i}").raw(),
                getattr(self, f"NonLocal_layer_{i}").raw())

    def forward(self, corr_feat, compat, mask=None, attention_fn=None, fused_layer_fn=None,
                compute_dtype=None, remat: bool = False):
        x = self.layer0(corr_feat)
        if fused_layer_fn is not None:
            for i in range(self.num_layers):
                with span("pointdsc.model.layer"):
                    x = fused_layer_fn(x, *self.layer_params(i))
            return x
        for i in range(self.num_layers):
            pcn = getattr(self, f"PointCN_layer_{i}")
            nl = getattr(self, f"NonLocal_layer_{i}")

            def pair(x, update_stats=True, pcn=pcn, nl=nl):
                x = pcn(x, mask, compute_dtype, update_stats)
                return nl(x, compat, mask=mask, attention_fn=attention_fn,
                          compute_dtype=compute_dtype, update_stats=update_stats)

            if remat and torch.is_grad_enabled():
                runs = []

                def pair_once(x, pair=pair, runs=runs):
                    runs.append(None)
                    return pair(x, update_stats=len(runs) == 1)

                x = checkpoint(pair_once, x, use_reentrant=False)
            else:
                x = pair(x)
        return x
