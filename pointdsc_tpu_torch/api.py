"""User entry points: load a snapshot, register correspondence sets."""

from __future__ import annotations

import json
import os

import torch

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.compat.flax_msgpack import load as load_msgpack
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.models.pointdsc import PointDSC, PointDSCOutput

_MODEL_KEYS = ("in_dim", "num_layers", "num_channels", "num_iterations", "ratio",
               "inlier_threshold", "sigma_d", "k", "nms_radius")


def load_pretrained(snapshot_dir: str, device: str | torch.device = "cuda",
                    offset_softmax: bool = True, half_precision: bool = False,
                    fused_cache_compat: bool = True) -> PointDSC:
    """PointDSC built from ``<snapshot_dir>/config.json`` with the weights of
    ``<snapshot_dir>/models/model_best.pkl`` (a flax msgpack checkpoint).
    ``offset_softmax``, ``half_precision`` and ``fused_cache_compat`` choose
    the fused path's encoder (models/pointdsc.py); the config's own
    ``half_precision`` and ``remat`` keys are training settings and are not
    read, as the JAX eval scripts leave them."""
    dev = resolve_device(device)
    with open(os.path.join(snapshot_dir, "config.json")) as f:
        cfg = json.load(f)
    model = PointDSC(**{k: cfg[k] for k in _MODEL_KEYS if k in cfg},
                     offset_softmax=offset_softmax, half_precision=half_precision,
                     fused_cache_compat=fused_cache_compat, device="cpu")
    raw = load_msgpack(os.path.join(snapshot_dir, "models", "model_best.pkl"))
    state = from_flax_variables({"params": raw["params"],
                                 "batch_stats": raw.get("batch_stats", {})})
    model.load_state_dict(state, strict=True)
    return model.to(dev).eval()


def register(corr_pos, src_keypts, tgt_keypts, mask=None, *, model: PointDSC,
             device: str | torch.device = "cuda") -> PointDSCOutput:
    """Run the fused eval forward on one batch, without gradients, in the
    configuration the model carries (models/pointdsc.py). Inputs are numpy
    arrays or tensors in the JAX layout ([B, N, in_dim], [B, N, 3],
    [B, N, 3], [B, N] bool); a single pair without the batch axis is accepted
    too."""
    dev = resolve_device(device)

    def as_tensor(a, dtype, extra_dims):
        t = torch.as_tensor(a)
        if t.ndim == extra_dims:
            t = t[None]
        return t.to(device=dev, dtype=dtype).contiguous()

    args = [as_tensor(a, torch.float32, 2) for a in (corr_pos, src_keypts, tgt_keypts)]
    m = None if mask is None else as_tensor(mask, torch.bool, 1)
    with torch.no_grad():
        return model(*args, mask=m, testing=True, fused=True)
