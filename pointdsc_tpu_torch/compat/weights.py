"""Weight bridge: flax variables and reference torch checkpoints -> the
port's state dict, and the state dict back to flax variables.

The port's module trees carry the flax names (models/blocks.py, PointDSC;
models/oanet.py, OANet), so a flax leaf maps onto one state-dict key:

    params/.../<name>/kernel [in, out]  ->  <path>.<name>.weight [out, in]
    params/.../<name>/bias              ->  <path>.<name>.bias
    params/.../<bn>/scale               ->  <path>.<bn>.weight
    batch_stats/.../<bn>/mean, var      ->  <path>.<bn>.running_mean, running_var
    params/sigma                        ->  sigma

The VoxelFCGF network's 3-D kernels have their own map (compat/fcgf_weights.py).
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


def _reference_readers(sd: dict):
    """(dense, bn_params, bn_stats): readers of a reference state dict's
    Conv1d(k=1) and BatchNorm1d entries under a key prefix, in the flax
    layout. A missing key raises KeyError."""

    def dense(prefix):
        return {"kernel": _conv1d(sd[f"{prefix}.weight"]),
                "bias": _vec(sd[f"{prefix}.bias"])}

    def bn_params(prefix):
        return {"scale": _vec(sd[f"{prefix}.weight"]),
                "bias": _vec(sd[f"{prefix}.bias"])}

    def bn_stats(prefix):
        return {"mean": _vec(sd[f"{prefix}.running_mean"]),
                "var": _vec(sd[f"{prefix}.running_var"])}

    return dense, bn_params, bn_stats


def from_torch_reference_state_dict(sd: dict, num_layers: int, dtype=np.float32) -> dict:
    """Reference PointDSC state dict (``torch.save(model.state_dict())``)
    -> flax-layout variables tree (the port's own copy of the JAX package's
    importer); ``from_flax_variables`` then gives the port's state dict.
    Raises KeyError on a missing expected key."""
    sd = {k: np.asarray(v, dtype) for k, v in sd.items()}
    dense, bn_params, bn_stats = _reference_readers(sd)

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


def from_torch_oanet_state_dict(sd: dict, num_layers: int, dtype=np.float32) -> dict:
    """Reference OANet state dict -> the flax-layout OANet tree (the port's
    own copy of the JAX package's importer; ``from_flax_variables`` then
    gives the port's state dict). The reference's Sequential indices ('post'
    activation order):

      l1_1: [Conv1d(in, C)] + per layer [Conv1d, ContextNorm, BatchNorm1d, ReLU]
            -> convs at 0, 1 + 4j; BatchNorms at 3 + 4j  (num_layers // 2 layers)
      l1_2: the same from Conv1d(2C, C), num_layers // 2 - 1 layers
      down1 / up1: conv = [InstanceNorm, BatchNorm, ReLU, Conv1d] -> BN .conv.1, Conv .conv.3
      l2.{i} (OAFilter): conv1 = [IN, BN, ReLU, Conv, Transpose] -> BN 1, Conv 3
                         conv2 = [BN, ReLU, Conv]                -> BN 0, Conv 2
                         conv3 = [Transpose, IN, BN, ReLU, Conv] -> BN 2, Conv 4
      output: Conv1d(C, 1)
    """
    sd = {k: np.asarray(v, dtype) for k, v in sd.items()}
    dense, bn_params, bn_stats = _reference_readers(sd)

    def stack(prefix, n_inner):
        p = {"Dense_0": dense(f"{prefix}.0")}
        s = {}
        for j in range(n_inner):
            p[f"Dense_{j + 1}"] = dense(f"{prefix}.{1 + 4 * j}")
            p[f"MaskedBatchNorm_{j}"] = bn_params(f"{prefix}.{3 + 4 * j}")
            s[f"MaskedBatchNorm_{j}"] = bn_stats(f"{prefix}.{3 + 4 * j}")
        return p, s

    half = num_layers // 2
    params: dict = {}
    stats: dict = {}
    params["l1_1"], stats["l1_1"] = stack("l1_1", half)
    params["l1_2"], stats["l1_2"] = stack("l1_2", half - 1)
    for name in ("down1", "up1"):
        params[name] = {"Dense_0": dense(f"{name}.conv.3"),
                        "MaskedBatchNorm_0": bn_params(f"{name}.conv.1")}
        stats[name] = {"MaskedBatchNorm_0": bn_stats(f"{name}.conv.1")}
    for i in range(half):
        blocks = ((0, "conv1", 3, 1), (1, "conv2", 2, 0), (2, "conv3", 4, 2))
        params[f"oa_{i}"] = {}
        stats[f"oa_{i}"] = {}
        for j, conv, dense_at, bn_at in blocks:
            params[f"oa_{i}"][f"Dense_{j}"] = dense(f"l2.{i}.{conv}.{dense_at}")
            params[f"oa_{i}"][f"MaskedBatchNorm_{j}"] = bn_params(f"l2.{i}.{conv}.{bn_at}")
            stats[f"oa_{i}"][f"MaskedBatchNorm_{j}"] = bn_stats(f"l2.{i}.{conv}.{bn_at}")
    params["output"] = dense("output")
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str, num_layers: int) -> dict:
    """A reference ``model_best.pkl`` (``torch.save`` of the reference
    PointDSC's state dict) as the flax-layout variables tree of
    ``from_torch_reference_state_dict`` (the JAX package's
    ``compat/torch_weights.py::load_torch_checkpoint``); ``from_flax_variables``
    of it is the port's state dict. Read with ``weights_only=True``: tensors
    and containers only, no pickled code runs."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return from_torch_reference_state_dict({k: v.numpy() for k, v in raw.items()}, num_layers)
