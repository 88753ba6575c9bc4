"""The fused forward's kernel gates against the JAX model's.

The JAX model runs its confidence-head kernel only on ``fused_attention and
testing and num_channels == 128`` and its exact seed k-NN kernel only on
``fused and num_corr >= _SEED_KNN_FUSED_MIN_N and k <= 128``
(``pointdsc_tpu/models/pointdsc.py``); outside them it runs plain math. The
port's predicates are held to those conditions as the JAX source states
them, on both sides of each gate, and the port's forward (on the CPU, where
the wrappers run their plain versions) is held to call its kernel wrappers
exactly where the predicates say.
"""

import inspect
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pointdsc_tpu.models.pointdsc as j_model
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.models import pointdsc as t_model

# (C, N, k) on both sides of each gate: the width, the size and the list length
CASES = [(128, 4096, 40), (128, 4095, 40), (32, 4096, 16), (128, 4096, 129), (32, 512, 16),
         (128, 1024, 16)]


def jax_condition(pattern: str) -> str:
    """The condition of the JAX model's ``if``/``elif`` that matches pattern."""
    found = re.search(pattern, inspect.getsource(j_model))
    assert found, f"the JAX model no longer gates on {pattern!r}"
    return found.group(1)


CONF_GATE = jax_condition(r"if (fused_attention and testing and self\.num_channels == \d+):")
KNN_GATE = jax_condition(
    r"elif (fused and num_corr >= _SEED_KNN_FUSED_MIN_N and k <= \d+):")


def test_seed_knn_constant_is_jax_s():
    assert t_model._SEED_KNN_FUSED_MIN_N == j_model._SEED_KNN_FUSED_MIN_N


@pytest.mark.parametrize("c,n,k", CASES)
def test_gate_predicates_match_jax(c, n, k):
    """Every combination of the flags, against JAX's own expressions."""
    for fused in (False, True):
        for testing in (False, True):
            want = eval(CONF_GATE, {"self": SimpleNamespace(num_channels=c)},  # noqa: S307
                        {"fused_attention": fused, "testing": testing})
            assert t_model.use_confidence_kernel(fused, testing, c) == want
        want = eval(KNN_GATE, {"_SEED_KNN_FUSED_MIN_N": j_model._SEED_KNN_FUSED_MIN_N},  # noqa: S307
                    {"fused": fused, "num_corr": n, "k": k})
        assert t_model.use_seed_knn_kernel(fused, n, k) == want


@pytest.mark.parametrize("c,n,k", CASES)
def test_forward_calls_kernels_where_the_gates_say(c, n, k, monkeypatch):
    """A one-layer model's fused eval forward on the CPU calls the two kernel
    wrappers exactly where the predicates say (k clamped to N - 1 first), and
    the C != 128 model runs on the CPU: only the card refuses it."""
    calls = {"conf": 0, "knn": 0}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(t_model, "confidence_head", spy("conf", t_model.confidence_head))
    monkeypatch.setattr(t_model, "seed_knn_exact", spy("knn", t_model.seed_knn_exact))
    model = t_model.PointDSC(num_layers=1, num_channels=c, k=k, offset_softmax=False,
                             device="cpu", generator=torch.Generator().manual_seed(0))
    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, seed=2)[0]
    args = [torch.as_tensor(np.asarray(ex[key], np.float32))[None]
            for key in ("corr_pos", "src_keypts", "tgt_keypts")]
    with torch.no_grad():
        out = model(*args, fused=True)
    assert bool(torch.isfinite(out.final_trans).all())
    assert calls["conf"] == int(t_model.use_confidence_kernel(True, True, c))
    assert calls["knn"] == int(t_model.use_seed_knn_kernel(True, n, min(k, n - 1)))
