"""The port's reader of a reference PyTorch checkpoint
(``pointdsc_tpu_torch/compat/weights.py::load_torch_checkpoint``) against the
JAX package's (``pointdsc_tpu/compat/torch_weights.py::load_torch_checkpoint``)
on a ``torch.save``d state dict in the reference's layout."""

import numpy as np
import pytest
import torch

from pointdsc_tpu.compat.torch_weights import load_torch_checkpoint as jax_load
from pointdsc_tpu_torch import PointDSC
from pointdsc_tpu_torch.compat.weights import from_flax_variables, load_torch_checkpoint


def leaves(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def reference_state_dict(rng, layers, c):
    """Random tensors under every key of the reference model's state dict
    (Conv1d weights [out, in, 1], BatchNorm1d with its running statistics
    and batch count)."""
    sd = {"sigma": rng.normal(size=(1,)), "sigma_spat": rng.normal(size=(1,)),
          "encoder.layer0.weight": rng.normal(size=(c, 6, 1)),
          "encoder.layer0.bias": rng.normal(size=(c,))}

    def conv(prefix, cin, cout):
        sd[f"{prefix}.weight"] = rng.normal(size=(cout, cin, 1))
        sd[f"{prefix}.bias"] = rng.normal(size=(cout,))

    def bn(prefix, ch):
        for name in ("weight", "bias", "running_mean"):
            sd[f"{prefix}.{name}"] = rng.normal(size=(ch,))
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, size=(ch,))

    for i in range(layers):
        conv(f"encoder.blocks.PointCN_layer_{i}.0", c, c)
        bn(f"encoder.blocks.PointCN_layer_{i}.1", c)
        nl = f"encoder.blocks.NonLocal_layer_{i}"
        for p in ("q", "k", "v"):
            conv(f"{nl}.projection_{p}", c, c)
        conv(f"{nl}.fc_message.0", c, c // 2)
        bn(f"{nl}.fc_message.1", c // 2)
        conv(f"{nl}.fc_message.3", c // 2, c // 2)
        bn(f"{nl}.fc_message.4", c // 2)
        conv(f"{nl}.fc_message.6", c // 2, c)
    conv("classification.0", c, 32)
    conv("classification.2", 32, 32)
    conv("classification.4", 32, 1)
    out = {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
    out["encoder.blocks.PointCN_layer_0.1.num_batches_tracked"] = torch.tensor(7)
    return out


@pytest.mark.parametrize("layers,c", [(2, 16), (12, 128)])
def test_load_torch_checkpoint_matches_jax_reader(tmp_path, layers, c):
    """Both readers on the same file: the same tree, leaf for leaf, bit for
    bit; the port's model loads the result strictly and holds the file's
    tensors (a Conv1d weight as its Linear weight)."""
    sd = reference_state_dict(np.random.default_rng(layers), layers, c)
    path = str(tmp_path / "model_best.pkl")
    torch.save(sd, path)
    ref = dict(leaves(jax_load(path, layers)))
    out = dict(leaves(load_torch_checkpoint(path, layers)))
    assert ref.keys() == out.keys()
    for key in ref:
        assert out[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(out[key], ref[key])
    model = PointDSC(num_layers=layers, num_channels=c, device="cpu")
    model.load_state_dict(from_flax_variables(load_torch_checkpoint(path, layers)), strict=True)
    np.testing.assert_array_equal(model.encoder.layer0.weight.detach().numpy(),
                                  sd["encoder.layer0.weight"][..., 0].numpy())
    np.testing.assert_array_equal(model.sigma.detach().numpy(), sd["sigma"].numpy())


def test_load_torch_checkpoint_refuses_pickled_code(tmp_path):
    """``weights_only=True``: a file that would run code when unpickled is
    refused, in both packages."""
    path = str(tmp_path / "evil.pkl")
    torch.save({"sigma": torch.ones(1), "hook": print}, path)
    for reader in (load_torch_checkpoint, jax_load):
        with pytest.raises(Exception):
            reader(path, 2)
