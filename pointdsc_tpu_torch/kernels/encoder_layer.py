"""Whole-encoder-layer kernels (PyTorch wrappers of ``csrc/encoder_layer.cu``;
counterparts of ``pointdsc_tpu/kernels/encoder_layer.py``).

One encoder layer (PointCN, then the spatial-consistency attention block with
its message MLP and residual) runs as one kernel up to ``MAX_FUSED_LAYER_N``
points and as a pair of kernels above it, with the eval-mode BatchNorms folded
into the Dense before them:

    h   = relu(x W1 + b1)                                   f32
    qkv = h Wqkv + bqkv, stored bf16; kscale = max_j ||k_j|| / sqrt(C)
    o   = offset-softmax attention over the int8 cache      (p rounded to bf16)
    out = h + (relu(relu(o Wm0 + bm0) Wm1 + bm1) Wm2 + bm2)  f32

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its kernel or raises. The kernels take C = 128 and N a multiple of
64 (every bucket of data/pipeline.py is one); the plain versions take any C
and N.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda
from pointdsc_tpu_torch.kernels.sc_attention import (
    C_KERNEL,
    inv_sqrt_c,
    key_bias,
    offset_attention_math,
    qk_scale,
)

# Up to this N the one-launch kernel runs, above it the pair. The value is the
# JAX package's (there it is the on-chip memory's limit); on the card the
# one-launch form keeps h, q, k, v in a workspace that stays in the L2 cache
# up to about this size (N C 10 bytes = 7.9 MB at 6144).
MAX_FUSED_LAYER_N = 6144
N_MULTIPLE = 64


def fold_bn(weight, bias, scale, bn_bias, mean, var, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the Dense before it. ``weight`` is
    [in, out]; returns (weight', bias') with y = x weight' + bias'."""
    a = scale / torch.sqrt(var + eps)
    return weight * a[None, :], bias * a + (bn_bias - mean * a)


def fold_layer(pcn_params, nl_params):
    """The ten f32 arrays the kernels read, from a layer's raw parameters in
    the layout of ``NonLocalNet.layer_params`` (Dense weights as PyTorch keeps
    them, [out, in]): (w1, b1, wqkv, bqkv, wm0, bm0, wm1, bm1, wm2, bm2) with
    every weight [in, out] and contiguous."""
    (w1, b1, (s1, bb1, m1, v1)) = pcn_params
    (wq, bq, wk, bk, wv, bv, wm0, bm0, (s0, bb0, mm0, vm0), wm1, bm1, (sm1, bbm1, mm1, vm1),
     wm2, bm2) = nl_params
    w1f, b1f = fold_bn(w1.t(), b1, s1, bb1, m1, v1)
    wqkv = torch.cat([wq.t(), wk.t(), wv.t()], dim=-1)
    bqkv = torch.cat([bq, bk, bv], dim=-1)
    wm0f, bm0f = fold_bn(wm0.t(), bm0, s0, bb0, mm0, vm0)
    wm1f, bm1f = fold_bn(wm1.t(), bm1, sm1, bbm1, mm1, vm1)
    return tuple(t.detach().float().contiguous()
                 for t in (w1f, b1f, wqkv, bqkv, wm0f, bm0f, wm1f, bm1f, wm2.t(), bm2))


def _flatten(pcn_params, nl_params):
    for p in (*pcn_params, *nl_params):
        if isinstance(p, tuple):
            yield from p
        else:
            yield p


def folded_weights(pcn_params, nl_params, cache: dict | None):
    """``fold_layer`` through ``cache`` (a dict the model owns, one entry per
    layer). An entry is reused while every raw tensor of the layer is the same
    object at the same address and version: ``load_state_dict``, an optimizer
    step, any in-place op and ``.to(device)`` all invalidate it. A write that
    PyTorch's version counter does not see (through ``.data``, or from outside
    PyTorch) does not: clear the dict after one."""
    if cache is None:
        return fold_layer(pcn_params, nl_params)
    raw = tuple(_flatten(pcn_params, nl_params))
    stamp = tuple((id(t), t.data_ptr(), t._version) for t in raw)
    slot = id(raw[0])
    hit = cache.get(slot)
    if hit is not None and hit[0] == stamp:
        return hit[2]
    weights = fold_layer(pcn_params, nl_params)
    cache[slot] = (stamp, raw, weights)  # raw: keeps the ids and addresses from being reused
    return weights


# ---------------------------------------------------------------- plain versions

def pcn_qkv_plain(x, weights):
    """Plain version of the PointCN + QKV kernel: h [B, N, C] f32, q, k, v
    bf16, kscale [B] f32 = max_j ||k_j|| / sqrt(C) over the rounded keys."""
    w1, b1, wqkv, bqkv = weights[:4]
    c = w1.shape[1]
    h = torch.relu(x @ w1 + b1)
    qkv = h @ wqkv + bqkv
    q, k, v = (qkv[..., i * c:(i + 1) * c].to(torch.bfloat16) for i in range(3))
    kf = k.float()
    kmax = torch.sqrt(torch.amax(torch.sum(kf * kf, dim=-1), dim=-1))
    return h, q, k, v, kmax * inv_sqrt_c(c)


def attn_mlp_residual_plain(kscale, q, k, v, compat, kbias, h, weights):
    """Plain version of the attention + message MLP + residual kernel.
    ``kbias`` [B, N] (0 valid, -1e9 masked) or None."""
    wm0, bm0, wm1, bm1, wm2, bm2 = weights[4:]
    o = offset_attention_math(q.float(), k.float(), v.float(), compat, kbias, kscale,
                              round_p=True)
    msg = torch.relu(o @ wm0 + bm0)
    msg = torch.relu(msg @ wm1 + bm1)
    return h + (msg @ wm2 + bm2)


def fused_layer_plain(x, compat, kbias, weights):
    """Plain version of the one-launch kernel: the same function as the pair."""
    h, q, k, v, kscale = pcn_qkv_plain(x, weights)
    return attn_mlp_residual_plain(kscale, q, k, v, compat, kbias, h, weights)


# ---------------------------------------------------------------- wrappers

def _check_weights(weights, c, device):
    shapes = ((c, c), (c,), (c, 3 * c), (3 * c,), (c, c // 2), (c // 2,), (c // 2, c // 2),
              (c // 2,), (c // 2, c), (c,))
    if len(weights) != len(shapes):
        raise ValueError(f"expected {len(shapes)} weight arrays, got {len(weights)}")
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        expect(w, f"weights[{i}]", dtype=torch.float32, shape=shape, device=device)


def _check_kernel_size(n, c):
    if c != C_KERNEL:
        raise ValueError(f"the encoder-layer kernels take C={C_KERNEL}, got C={c}")
    if n % N_MULTIPLE:
        raise ValueError(f"the encoder-layer kernels take N a multiple of {N_MULTIPLE}, got {n}")


def _check_layer_inputs(x, compat, kbias, weights):
    expect(x, "x", dtype=torch.float32, ndim=3)
    b, n, c = x.shape
    expect(compat, "compat", dtype=torch.int8, shape=(b, n, n), device=x.device)
    if kbias is not None:
        expect(kbias, "kbias", dtype=torch.float32, shape=(b, n), device=x.device)
    _check_weights(weights, c, x.device)
    return b, n, c


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _workspace(b, n, c, device):
    h = torch.empty((b, n, c), dtype=torch.float32, device=device)
    q, k, v = (torch.empty((b, n, c), dtype=torch.bfloat16, device=device) for _ in range(3))
    kscale = torch.empty((b,), dtype=torch.float32, device=device)
    return h, q, k, v, kscale


def fused_encoder_layer(x, compat, kbias, weights):
    """One encoder layer in one launch. x [B, N, C] f32, compat [B, N, N]
    int8, kbias [B, N] f32 or None (no mask), weights from ``fold_layer``.
    Returns [B, N, C] f32. The kernel needs a cooperative launch (a grid-wide
    barrier between its two phases) and raises if the card refuses it."""
    b, n, c = _check_layer_inputs(x, compat, kbias, weights)
    if not on_cuda(x):
        return fused_layer_plain(x, compat, kbias, weights)
    _check_kernel_size(n, c)
    h, q, k, v, kscale = _workspace(b, n, c, x.device)
    out = torch.empty_like(x)
    fused_encoder_layer.launches += 1
    _build.launch("encoder_layer", "fused_encoder_layer", x.device,
                  x.data_ptr(), compat.data_ptr(), _ptr(kbias),
                  *(w.data_ptr() for w in weights),
                  h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), kscale.data_ptr(),
                  out.data_ptr(), b, n, qk_scale(c), inv_sqrt_c(c))
    return out


fused_encoder_layer.launches = 0


def pcn_qkv(x, weights):
    """PointCN + QKV in one launch: (h f32, q, k, v bf16, kscale [B] f32)."""
    expect(x, "x", dtype=torch.float32, ndim=3)
    b, n, c = x.shape
    _check_weights(weights, c, x.device)
    if not on_cuda(x):
        return pcn_qkv_plain(x, weights)
    _check_kernel_size(n, c)
    h, q, k, v, kscale = _workspace(b, n, c, x.device)
    pcn_qkv.launches += 1
    _build.launch("encoder_layer", "pcn_qkv", x.device,
                  x.data_ptr(), *(w.data_ptr() for w in weights[:4]),
                  h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), kscale.data_ptr(),
                  b, n, inv_sqrt_c(c))
    return h, q, k, v, kscale


pcn_qkv.launches = 0


def attn_mlp_residual(kscale, q, k, v, compat, kbias, h, weights):
    """Offset attention + message MLP + residual in one launch, on the
    outputs of ``pcn_qkv``. Returns [B, N, C] f32."""
    expect(h, "h", dtype=torch.float32, ndim=3)
    b, n, c = h.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        expect(t, name, dtype=torch.bfloat16, shape=h.shape, device=h.device)
    expect(kscale, "kscale", dtype=torch.float32, shape=(b,), device=h.device)
    expect(compat, "compat", dtype=torch.int8, shape=(b, n, n), device=h.device)
    if kbias is not None:
        expect(kbias, "kbias", dtype=torch.float32, shape=(b, n), device=h.device)
    _check_weights(weights, c, h.device)
    if not on_cuda(h):
        return attn_mlp_residual_plain(kscale, q, k, v, compat, kbias, h, weights)
    _check_kernel_size(n, c)
    out = torch.empty_like(h)
    attn_mlp_residual.launches += 1
    _build.launch("encoder_layer", "attn_mlp_residual", h.device,
                  kscale.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  compat.data_ptr(), _ptr(kbias), h.data_ptr(),
                  *(w.data_ptr() for w in weights[4:]), out.data_ptr(), b, n, qk_scale(c))
    return out


attn_mlp_residual.launches = 0


def fused_layer(x, compat, kbias, weights):
    """The JAX dispatch: one launch up to ``MAX_FUSED_LAYER_N``, the pair above."""
    if x.shape[1] <= MAX_FUSED_LAYER_N:
        return fused_encoder_layer(x, compat, kbias, weights)
    h, q, k, v, kscale = pcn_qkv(x, weights)
    return attn_mlp_residual(kscale, q, k, v, compat, kbias, h, weights)


def make_fused_layer_fn(compat_cache, mask=None, fold_cache: dict | None = None):
    """The per-layer hook of ``NonLocalNet.forward(fused_layer_fn=...)``:
    fn(x, pcn_params, nl_params) -> x over the shared [B, N, N] int8 cache.
    With ``mask=None`` no key bias is read (all keys valid). ``fold_cache``:
    see ``folded_weights``; without it the BatchNorms are folded per call."""
    b, n = compat_cache.shape[:2]
    kbias = None if mask is None else key_bias(mask, b, n, compat_cache.device)

    def layer_fn(x, pcn_params, nl_params):
        weights = folded_weights(pcn_params, nl_params, fold_cache)
        return fused_layer(x.float().contiguous(), compat_cache, kbias, weights)

    return layer_fn
