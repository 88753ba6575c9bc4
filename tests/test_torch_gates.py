"""The fused forward's kernel gates, and the cached attention's operand
type, against the JAX model's and wrapper's.

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
from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.kernels._check import C_KERNEL
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
    the C != 128 model runs fused (the card takes any width too)."""
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


# The cached attention's operands. JAX's wrapper rounds q, k, v to bf16 off
# the CPU, before it picks the offset or the running-max kernel, so both
# kernels take bf16 there; in interpret mode (the CPU) they keep their type.
CAST_GATE = re.search(
    r"if (use_bf16 and not interpret):\n\s+q = q\.astype\(jnp\.bfloat16\)",
    inspect.getsource(j_att.fused_sc_attention_cached))


def test_jax_casts_for_both_cached_kernels():
    """The cast is there, ``use_bf16`` defaults to True, the eval model's
    attention function leaves it at that default, and the cast comes before
    the offset flag picks the kernel."""
    assert CAST_GATE, "the JAX wrapper no longer casts q, k, v to bf16"
    src = inspect.getsource(j_att.fused_sc_attention_cached)
    assert inspect.signature(j_att.fused_sc_attention_cached).parameters["use_bf16"].default
    assert "use_bf16" not in inspect.getsource(j_att.make_sc_attention_fn)
    assert src.index(CAST_GATE.group(0)) < src.index("offset_softmax=offset_softmax")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset_softmax", [False, True])
@pytest.mark.parametrize("on_card", [False, True])
def test_cached_kernels_take_jax_s_operands(on_card, offset_softmax, dtype, monkeypatch):
    """The port's wrapper hands both cached kernels (or, on the CPU, their
    plain versions) the operand type JAX's cast gives at the same place: a
    card stands in for the TPU (not interpret mode), the CPU for interpret
    mode. The launches are replaced by spies, so no card is needed."""
    seen = []

    def spy(*args):
        seen.append(tuple(t.dtype for t in args[:3]))
        return torch.zeros(args[0].shape)

    for name in ("_launch_sc_attention", "_launch_sc_attention_offset",
                 "sc_attention_cached_plain", "sc_attention_cached_offset_plain"):
        monkeypatch.setattr(t_att, name, spy)
    monkeypatch.setattr(t_att, "on_cuda", lambda t: on_card)
    for fn in (t_att.fused_sc_attention_cached, t_att.sc_attention_cached_offset):
        monkeypatch.setattr(fn, "launches", 0)
    n = 16
    q = torch.ones((1, n, C_KERNEL), dtype=dtype)
    pts = torch.zeros((1, n, 3))
    compat = torch.zeros((1, n, n), dtype=torch.int8)
    t_att.fused_sc_attention_cached(q, q.clone(), q.clone(), compat, pts, pts,
                                    offset_softmax=offset_softmax)
    cast = eval(CAST_GATE.group(1), {}, {"use_bf16": True,  # noqa: S307
                                          "interpret": not on_card})
    assert seen == [(torch.bfloat16 if cast else dtype,) * 3]


# The no-cache attention's operands: JAX's fused_sc_attention (the model's
# fused_cache_compat=False path) makes the same cast off the CPU.
NOCACHE_CAST = re.search(
    r"if (use_bf16 and not interpret):\n\s+q = q\.astype\(jnp\.bfloat16\)",
    inspect.getsource(j_att.fused_sc_attention))


def test_jax_casts_for_the_no_cache_kernel():
    """The cast is there, ``use_bf16`` defaults to True, and the model's
    attention function leaves it at that default."""
    assert NOCACHE_CAST, "the JAX no-cache wrapper no longer casts q, k, v to bf16"
    assert inspect.signature(j_att.fused_sc_attention).parameters["use_bf16"].default
    assert "use_bf16" not in inspect.getsource(j_att.make_sc_attention_fn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("on_card", [False, True])
def test_no_cache_kernel_takes_jax_s_operands(on_card, dtype, monkeypatch):
    """``fused_sc_attention`` hands the no-cache kernel (or, on the CPU, its
    plain version) the operand type JAX's cast gives: bf16 on a card (not
    interpret mode), the caller's type on the CPU (interpret mode). The
    launch is replaced by a spy, so no card is needed."""
    seen = []

    def spy(*args):
        seen.append(tuple(t.dtype for t in args[:3]))
        return torch.zeros(args[0].shape)

    for name in ("_launch_sc_attention_nocache", "sc_attention_nocache_plain"):
        monkeypatch.setattr(t_att, name, spy)
    monkeypatch.setattr(t_att, "on_cuda", lambda t: on_card)
    monkeypatch.setattr(t_att.fused_sc_attention, "launches", 0)
    n = 16
    q = torch.ones((1, n, C_KERNEL), dtype=dtype)
    pts = torch.zeros((1, n, 3))
    t_att.fused_sc_attention(q, q.clone(), q.clone(), pts, pts, 0.1)
    cast = eval(NOCACHE_CAST.group(1), {}, {"use_bf16": True,  # noqa: S307
                                             "interpret": not on_card})
    assert seen == [(torch.bfloat16 if cast else dtype,) * 3]
    assert t_att.fused_sc_attention.launches == int(on_card)
