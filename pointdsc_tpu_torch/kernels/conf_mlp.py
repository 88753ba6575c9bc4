"""Confidence head, 128 -> 32 -> 32 -> 1 with ReLUs (PyTorch wrapper of
``csrc/conf_mlp.cu``; counterpart of ``pointdsc_tpu/kernels/conf_mlp.py``).

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda

C_KERNEL, HIDDEN = 128, 32  # the kernel's compiled widths


def confidence_head_plain(features, w0, b0, w1, b1, w2, b2):
    """Plain version: the three nn.Linear layers of the dense path."""
    x = F.relu(F.linear(features, w0, b0))
    x = F.relu(F.linear(x, w1, b1))
    return F.linear(x, w2, b2)[..., 0]


def _launch_conf(features, w0, b0, w1, b1, w2, b2):
    m = features.shape[0] * features.shape[1]
    out = torch.empty(features.shape[:2], dtype=torch.float32, device=features.device)
    _build.launch("conf_mlp", "confidence_head", features.device, features.data_ptr(),
                  w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), out.data_ptr(), m)
    return out


def confidence_head(features, w0, b0, w1, b1, w2, b2):
    """Logits [B, N] from features [B, N, 128] and the weights of the three
    layers in nn.Linear's layout: w0 [32, 128], w1 [32, 32], w2 [1, 32]."""
    expect(features, "features", dtype=torch.float32, ndim=3)
    shapes = ((w0, "w0", (HIDDEN, features.shape[-1])), (b0, "b0", (HIDDEN,)),
              (w1, "w1", (HIDDEN, HIDDEN)), (b1, "b1", (HIDDEN,)),
              (w2, "w2", (1, HIDDEN)), (b2, "b2", (1,)))
    for t, name, shape in shapes:
        expect(t, name, dtype=torch.float32, shape=shape, device=features.device)
    if not on_cuda(features):
        return confidence_head_plain(features, w0, b0, w1, b1, w2, b2)
    if features.shape[-1] != C_KERNEL:
        raise ValueError(f"the confidence kernel takes C={C_KERNEL}, got C={features.shape[-1]}")
    confidence_head.launches += 1
    return _launch_conf(features, w0, b0, w1, b1, w2, b2)


confidence_head.launches = 0
