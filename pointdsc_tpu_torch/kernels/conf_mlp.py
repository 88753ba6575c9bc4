"""Confidence head, 128 -> 32 -> 32 -> 1 with ReLUs (PyTorch wrapper of
``csrc/conf_mlp.cu``; counterpart of ``pointdsc_tpu/kernels/conf_mlp.py``).

The kernel reads the three layers' weights packed into one f32 buffer
(``pack_head_weights``), which the model packs once and keeps
(``packed_head_weights``). On a CPU tensor the wrapper runs its plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda

C_KERNEL, HIDDEN = 128, 32  # the kernel's compiled widths
# The packed layout (csrc/conf_mlp.cu): W0^T [128, 32], b0, W1^T [32, 32], b1,
# w2 [32], b2, zero-padded to a multiple of 4 floats.
_SIZES = (C_KERNEL * HIDDEN, HIDDEN, HIDDEN * HIDDEN, HIDDEN, HIDDEN, 1)
PACKED_FLOATS = (sum(_SIZES) + 3) // 4 * 4
_SHAPES = ((HIDDEN, C_KERNEL), (HIDDEN,), (HIDDEN, HIDDEN), (HIDDEN,), (1, HIDDEN), (1,))


def confidence_head_plain(features, w0, b0, w1, b1, w2, b2):
    """Plain version: the three nn.Linear layers of the dense path."""
    x = F.relu(F.linear(features, w0, b0))
    x = F.relu(F.linear(x, w1, b1))
    return F.linear(x, w2, b2)[..., 0]


def pack_head_weights(w0, b0, w1, b1, w2, b2):
    """The [PACKED_FLOATS] f32 buffer the kernel reads, from the three layers'
    weights in nn.Linear's layout: w0 [32, 128], w1 [32, 32], w2 [1, 32]."""
    head = (w0, b0, w1, b1, w2, b2)
    for i, (t, shape) in enumerate(zip(head, _SHAPES)):
        expect(t.detach(), f"head[{i}]", dtype=torch.float32, shape=shape, device=w0.device)
    parts = [w0.t(), b0, w1.t(), b1, w2, b2,
             torch.zeros(PACKED_FLOATS - sum(_SIZES), device=w0.device)]
    return torch.cat([p.detach().reshape(-1) for p in parts]).contiguous()


def unpack_head_weights(packed):
    """The six tensors of ``pack_head_weights``' input, as views of packed."""
    views, at = [], 0
    for size, shape in zip(_SIZES, _SHAPES):
        views.append(packed[at:at + size])
        at += size
    w0t, b0, w1t, b1, w2, b2 = views
    return (w0t.view(C_KERNEL, HIDDEN).t(), b0, w1t.view(HIDDEN, HIDDEN).t(), b1,
            w2.view(1, HIDDEN), b2)


def packed_head_weights(head, cache: dict | None):
    """``pack_head_weights(*head)`` through ``cache`` (a dict the model owns):
    reused while every tensor of ``head`` is the same object at the same
    address and version, as ``encoder_layer.folded_weights`` reuses its
    entries (``load_state_dict``, an optimizer step and ``.to(device)``
    invalidate it)."""
    if cache is None:
        return pack_head_weights(*head)
    stamp = tuple((id(t), t.data_ptr(), t._version) for t in head)
    hit = cache.get("head")
    if hit is not None and hit[0] == stamp:
        return hit[2]
    packed = pack_head_weights(*head)
    cache["head"] = (stamp, tuple(head), packed)  # keeps the ids and addresses from being reused
    return packed


def confidence_head(features, packed):
    """Logits [B, N] from features [B, N, 128] f32 and the head's weights
    packed by ``pack_head_weights``."""
    expect(features, "features", dtype=torch.float32, ndim=3, last=C_KERNEL)
    expect(packed, "packed", dtype=torch.float32, shape=(PACKED_FLOATS,), device=features.device)
    if not on_cuda(features):
        return confidence_head_plain(features, *unpack_head_weights(packed))
    if features.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("features and packed must be 16-byte aligned (16-byte copies)")
    out = torch.empty(features.shape[:2], dtype=torch.float32, device=features.device)
    confidence_head.launches += 1
    _build.launch("conf_mlp", "confidence_head", features.device, features.data_ptr(),
                  packed.data_ptr(), out.data_ptr(), features.shape[0] * features.shape[1])
    return out


confidence_head.launches = 0
