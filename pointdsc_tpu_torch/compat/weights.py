"""Weight bridge: flax variables and reference torch checkpoints -> the
port's state dict, and the state dict back to flax variables.

The port's module tree carries the flax names (models/blocks.py), so a flax
leaf maps onto one state-dict key:

    params/.../<name>/kernel [in, out]  ->  <path>.<name>.weight [out, in]
    params/.../<name>/bias              ->  <path>.<name>.bias
    params/.../<bn>/scale               ->  <path>.<bn>.weight
    batch_stats/.../<bn>/mean, var      ->  <path>.<bn>.running_mean, running_var
    params/sigma                        ->  sigma
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var", "sigma": "sigma"}


def _walk(tree: dict, prefix: tuple = ()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def from_flax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} tree of numpy arrays -> state dict
    of float32 CPU tensors. Raises on a leaf name it does not know."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            leaf = path[-1]
            if leaf not in _LEAF:
                raise KeyError(f"unknown flax leaf {'/'.join(path)}")
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if leaf == "kernel":
                arr = np.ascontiguousarray(arr.T)
            key = ".".join(path[:-1] + (_LEAF[leaf],))
            state[key] = torch.from_numpy(arr)
    return state


def to_flax_variables(state: dict) -> dict:
    """The inverse of ``from_flax_variables``: a state dict of the port ->
    {'params': ..., 'batch_stats': ...} tree of float32 numpy arrays in the
    flax layout (Dense kernels [in, out])."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu().numpy().astype(np.float32)
        if leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            collection, name = "params", "kernel" if arr.ndim == 2 else "scale"
            if arr.ndim == 2:
                arr = np.ascontiguousarray(arr.T)
        elif leaf in ("bias", "sigma"):
            collection, name = "params", leaf
        else:
            raise KeyError(f"unknown state-dict key {key}")
        node = out[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = arr
    return out


def _conv1d(w):  # [out, in, 1] -> [in, out]
    return np.ascontiguousarray(np.asarray(w)[:, :, 0].T)


def _vec(w):
    return np.asarray(w).reshape(-1)


def from_torch_reference_state_dict(sd: dict, num_layers: int, dtype=np.float32) -> dict:
    """Reference PointDSC state dict (``torch.save(model.state_dict())``)
    -> flax-layout variables tree (the port's own copy of the JAX package's
    importer); ``from_flax_variables`` then gives the port's state dict.
    Raises KeyError on a missing expected key."""
    sd = {k: np.asarray(v, dtype) for k, v in sd.items()}

    def dense(prefix):
        return {"kernel": _conv1d(sd[f"{prefix}.weight"]),
                "bias": _vec(sd[f"{prefix}.bias"])}

    def bn_params(prefix):
        return {"scale": _vec(sd[f"{prefix}.weight"]),
                "bias": _vec(sd[f"{prefix}.bias"])}

    def bn_stats(prefix):
        return {"mean": _vec(sd[f"{prefix}.running_mean"]),
                "var": _vec(sd[f"{prefix}.running_var"])}

    enc_p: dict = {"layer0": dense("encoder.layer0")}
    enc_s: dict = {}
    for i in range(num_layers):
        pcn = f"encoder.blocks.PointCN_layer_{i}"
        nl = f"encoder.blocks.NonLocal_layer_{i}"
        enc_p[f"PointCN_layer_{i}"] = {
            "Dense_0": dense(f"{pcn}.0"),
            "MaskedBatchNorm_0": bn_params(f"{pcn}.1"),
        }
        enc_s[f"PointCN_layer_{i}"] = {"MaskedBatchNorm_0": bn_stats(f"{pcn}.1")}
        enc_p[f"NonLocal_layer_{i}"] = {
            "projection_q": dense(f"{nl}.projection_q"),
            "projection_k": dense(f"{nl}.projection_k"),
            "projection_v": dense(f"{nl}.projection_v"),
            "fc_message_0": dense(f"{nl}.fc_message.0"),
            "fc_message_bn0": bn_params(f"{nl}.fc_message.1"),
            "fc_message_1": dense(f"{nl}.fc_message.3"),
            "fc_message_bn1": bn_params(f"{nl}.fc_message.4"),
            "fc_message_2": dense(f"{nl}.fc_message.6"),
        }
        enc_s[f"NonLocal_layer_{i}"] = {
            "fc_message_bn0": bn_stats(f"{nl}.fc_message.1"),
            "fc_message_bn1": bn_stats(f"{nl}.fc_message.4"),
        }

    params = {
        "sigma": _vec(sd["sigma"]),
        "encoder": enc_p,
        "classification_0": dense("classification.0"),
        "classification_1": dense("classification.2"),
        "classification_2": dense("classification.4"),
    }
    return {"params": params, "batch_stats": {"encoder": enc_s}}
