"""Weight bridge of the VoxelFCGF descriptor network: flax variables <-> the
port's state dict (descriptors/fcgf.py).

The port's module tree carries the flax names, so each flax leaf maps onto
one state-dict key:

    params/.../Conv_i/kernel [kd, kh, kw, in, out]   ->  ...Conv_i.weight [out, in, kd, kh, kw]
    params/ConvTranspose_j/kernel [kd, kh, kw, in, out]
                              ->  ConvTranspose_j.weight [in, out, kd, kh, kw], spatially flipped
    params/.../<bn>/scale, bias                      ->  <bn>.weight, <bn>.bias
    batch_stats/.../<bn>/mean, var                   ->  <bn>.running_mean, running_var

flax's transposed convolution correlates the dilated input with the kernel
as stored; ``conv_transpose3d`` correlates it with the kernel flipped, hence
the flip (its own inverse). ``save_fcgf_checkpoint`` writes the flax
msgpack that the reference's ``flax.serialization.from_bytes`` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch.compat import flax_msgpack
from pointdsc_tpu_torch.compat.weights import _LEAF, _walk


def _is_transpose(path) -> bool:
    return path[-1].startswith("ConvTranspose")


def from_flax_fcgf_variables(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} tree of numpy arrays -> state dict
    of float32 CPU tensors. Raises on a leaf name it does not know."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            leaf = path[-1]
            if leaf not in _LEAF or leaf == "sigma":
                raise KeyError(f"unknown flax leaf {'/'.join(path)}")
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if leaf == "kernel":
                if _is_transpose(path[:-1]):
                    arr = arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
                else:
                    arr = arr.transpose(4, 3, 0, 1, 2)
                arr = np.ascontiguousarray(arr)
            state[".".join(path[:-1] + (_LEAF[leaf],))] = torch.from_numpy(arr)
    return state


def to_flax_fcgf_variables(state: dict) -> dict:
    """The inverse of ``from_flax_fcgf_variables``: a VoxelFCGF state dict ->
    {'params': ..., 'batch_stats': ...} tree of float32 numpy arrays."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu().numpy().astype(np.float32)
        if leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and arr.ndim == 5:
            collection, name = "params", "kernel"
            if _is_transpose(path):
                arr = arr.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
            else:
                arr = arr.transpose(2, 3, 4, 1, 0)
            arr = np.ascontiguousarray(arr)
        elif leaf == "weight":
            collection, name = "params", "scale"
        elif leaf == "bias":
            collection, name = "params", "bias"
        else:
            raise KeyError(f"unknown state-dict key {key}")
        node = out[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = arr
    return out


def load_fcgf_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A flax VoxelFCGF checkpoint file -> the port's state dict."""
    return from_flax_fcgf_variables(flax_msgpack.load(path))


def save_fcgf_checkpoint(model: torch.nn.Module, path: str) -> None:
    """The model's weights as the reference's flax checkpoint file."""
    with open(path, "wb") as f:
        f.write(flax_msgpack.dumps(to_flax_fcgf_variables(model.state_dict())))
