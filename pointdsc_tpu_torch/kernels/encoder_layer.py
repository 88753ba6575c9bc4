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
it launches its kernel or raises. The kernels work in chunks of 128 channels:
a layer is zero-padded to the next multiple of 128 (``pad_layer_weights``; the
message MLP's C/2 to a multiple of 64) and sliced back, with the 1/sqrt(C)
constants of the layer's own width. Above C = 128 a layer runs as the pair at
every N: the one-launch kernel keeps a C x C weight matrix in shared memory.
Those that hold the attention also take N a multiple of 64 (every bucket of
data/pipeline.py is one). The plain versions take any C and N.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import (
    C_KERNEL,
    check_width,
    expect,
    expect_aligned,
    on_cuda,
    pad_channels,
    padded_width,
    unpad_channels,
)
from pointdsc_tpu_torch.kernels.sc_attention import (
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
MLP_MULTIPLE = 64  # the message MLP's inner width on the card is a multiple of it


def mlp_width(c: int) -> int:
    """The message MLP's inner width C/2 of a C-wide layer, padded as the
    kernels take it: 64 up to C = 128, else a multiple of 64."""
    return MLP_MULTIPLE * max(1, -(-(c // 2) // MLP_MULTIPLE))


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

def pcn_qkv_plain(x, weights, c=None):
    """Plain version of the PointCN + QKV kernel: h [B, N, C] f32, q, k, v
    bf16, kscale [B] f32 = max_j ||k_j|| / sqrt(C) over the rounded keys.
    ``c``: the model's width, whose 1/sqrt(C) kscale takes (the layer's
    width when None; padded weights pass the unpadded width)."""
    w1, b1, wqkv, bqkv = weights[:4]
    w = w1.shape[1]
    h = torch.relu(x @ w1 + b1)
    qkv = h @ wqkv + bqkv
    q, k, v = (qkv[..., i * w:(i + 1) * w].to(torch.bfloat16) for i in range(3))
    kf = k.float()
    kmax = torch.sqrt(torch.amax(torch.sum(kf * kf, dim=-1), dim=-1))
    return h, q, k, v, kmax * inv_sqrt_c(c or w)


def attn_mlp_residual_plain(kscale, q, k, v, compat, kbias, h, weights, c=None):
    """Plain version of the attention + message MLP + residual kernel.
    ``kbias`` [B, N] (0 valid, -1e9 masked) or None; ``c`` as in
    ``pcn_qkv_plain``."""
    wm0, bm0, wm1, bm1, wm2, bm2 = weights[4:]
    o = offset_attention_math(q.float(), k.float(), v.float(), compat, kbias, kscale,
                              round_p=True, c=c)
    msg = torch.relu(o @ wm0 + bm0)
    msg = torch.relu(msg @ wm1 + bm1)
    return h + (msg @ wm2 + bm2)


def fused_layer_plain(x, compat, kbias, weights, c=None):
    """Plain version of the one-launch kernel: the same function as the pair."""
    h, q, k, v, kscale = pcn_qkv_plain(x, weights, c)
    return attn_mlp_residual_plain(kscale, q, k, v, compat, kbias, h, weights, c)


def pad_layer_weights(weights, c):
    """``fold_layer``'s ten arrays of a C-wide layer zero-padded to the
    kernels' width, ``padded_width(c)`` (the message MLP's C/2 to
    ``mlp_width(c)``; q, k and v each padded in their own third of wqkv), so
    that the padded channels of h, q, k, v, the message and the output stay
    exact zeros. The weights themselves at C = 128."""
    if c == C_KERNEL:
        return weights
    w1, b1, wqkv, bqkv, wm0, bm0, wm1, bm1, wm2, bm2 = weights
    full, half = padded_width(c), mlp_width(c)

    def pad2(w, rows, cols):
        return torch.nn.functional.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))

    def thirds(t):  # [..., 3c] -> [..., 3 * full]
        return torch.cat([pad_channels(t[..., i * c:(i + 1) * c], full) for i in range(3)],
                         dim=-1)

    return (pad2(w1, full, full), pad_channels(b1, full), pad2(thirds(wqkv), full, 3 * full),
            thirds(bqkv), pad2(wm0, full, half), pad_channels(bm0, half),
            pad2(wm1, half, half), pad_channels(bm1, half), pad2(wm2, half, full),
            pad_channels(bm2, full))


# ---------------------------------------------------------------- wrappers

def _check_weights(weights, c, device):
    shapes = ((c, c), (c,), (c, 3 * c), (3 * c,), (c, c // 2), (c // 2,), (c // 2, c // 2),
              (c // 2,), (c // 2, c), (c,))
    if len(weights) != len(shapes):
        raise ValueError(f"expected {len(shapes)} weight arrays, got {len(weights)}")
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        expect(w, f"weights[{i}]", dtype=torch.float32, shape=shape, device=device)


def _check_kernel_size(n, c, any_n=False):
    check_width(c, "the encoder-layer kernels")
    if n % N_MULTIPLE and not any_n:
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


def new_workspace(b, n, c, device):
    """(h f32, q, k, v bf16, kscale [B] f32), uninitialised: what ``pcn_qkv``
    and ``fused_encoder_layer`` write. Launches are ordered on the stream, so
    one workspace serves every layer of a forward."""
    h = torch.empty((b, n, c), dtype=torch.float32, device=device)
    q, k, v = (torch.empty((b, n, c), dtype=torch.bfloat16, device=device) for _ in range(3))
    kscale = torch.empty((b,), dtype=torch.float32, device=device)
    return h, q, k, v, kscale


def _take_workspace(workspace, b, n, c, device):
    if workspace is None:
        return new_workspace(b, n, c, device)
    if len(workspace) != 5:
        raise ValueError(f"expected a workspace of 5 tensors, got {len(workspace)}")
    for name, t, dtype, shape in zip(
            ("h", "q", "k", "v", "kscale"), workspace,
            (torch.float32,) + (torch.bfloat16,) * 3 + (torch.float32,),
            ((b, n, c),) * 4 + ((b,),)):
        expect(t, f"workspace {name}", dtype=dtype, shape=shape, device=device)
    expect_aligned(dict(zip(("h", "q", "k", "v"), workspace)))
    return workspace


def fused_encoder_layer(x, compat, kbias, weights, workspace=None):
    """One encoder layer in one launch. x [B, N, C] f32, compat [B, N, N]
    int8, kbias [B, N] f32 or None (no mask), weights from ``fold_layer``,
    ``workspace`` from ``new_workspace`` at C = 128 (allocated here if None).
    Returns [B, N, C] f32. The kernel needs a cooperative launch (a
    grid-wide barrier between its two phases) and raises if the card
    refuses it. It takes C <= 128 (zero-padded to 128): it keeps a C x C
    weight matrix in shared memory, so ``fused_layer`` runs a wider layer as
    the pair."""
    b, n, c = _check_layer_inputs(x, compat, kbias, weights)
    if not on_cuda(x):
        return fused_layer_plain(x, compat, kbias, weights)
    _check_kernel_size(n, c)
    if padded_width(c) != C_KERNEL:
        raise ValueError(f"the one-launch layer kernel holds one {C_KERNEL}-channel chunk, got "
                         f"C={c}: fused_layer runs a wider layer as the pair")
    x, weights = pad_channels(x), pad_layer_weights(weights, c)
    h, q, k, v, kscale = _take_workspace(workspace, b, n, C_KERNEL, x.device)
    out = torch.empty_like(x)
    fused_encoder_layer.launches += 1
    _build.launch("encoder_layer", "fused_encoder_layer", x.device,
                  x.data_ptr(), compat.data_ptr(), _ptr(kbias),
                  *(w.data_ptr() for w in weights),
                  h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), kscale.data_ptr(),
                  out.data_ptr(), b, n, qk_scale(c), inv_sqrt_c(c))
    return unpad_channels(out, c)


fused_encoder_layer.launches = 0


def pcn_qkv(x, weights, workspace=None):
    """PointCN + QKV in one launch: (h f32, q, k, v bf16, kscale [B] f32),
    written into ``workspace`` (from ``new_workspace``, at the layer's width
    on the CPU and at ``padded_width(C)`` on the card) when one is given, or
    into new tensors. Any N. Where C is not a multiple of 128 the card
    returns new unpadded tensors."""
    expect(x, "x", dtype=torch.float32, ndim=3)
    b, n, c = x.shape
    _check_weights(weights, c, x.device)
    if not on_cuda(x):
        ref = pcn_qkv_plain(x, weights)
        if workspace is None:
            return ref
        for dst, src in zip(_take_workspace(workspace, b, n, c, x.device), ref):
            dst.copy_(src)
        return workspace
    _check_kernel_size(n, c, any_n=True)
    x, weights = pad_channels(x), pad_layer_weights(weights, c)
    expect_aligned({"x": x, **{f"weights[{i}]": w for i, w in enumerate(weights[:4])}})
    w = x.shape[-1]
    h, q, k, v, kscale = _take_workspace(workspace, b, n, w, x.device)
    pcn_qkv.launches += 1
    _build.launch("encoder_layer", "pcn_qkv", x.device,
                  x.data_ptr(), *(t.data_ptr() for t in weights[:4]),
                  h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), kscale.data_ptr(),
                  b, n, w, inv_sqrt_c(c))
    return (*(unpad_channels(t, c) for t in (h, q, k, v)), kscale)


pcn_qkv.launches = 0


def attn_mlp_residual(kscale, q, k, v, compat, kbias, h, weights):
    """Offset attention + message MLP + residual in one launch, on the
    outputs of ``pcn_qkv``. Returns [B, N, C] f32. Above C = 128 the kernel
    makes one attention pass per 128-wide output chunk and runs the message
    MLP through a workspace [B, N, W + 2 ``mlp_width``] f32 allocated here."""
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
    q, k, v, h = (pad_channels(t) for t in (q, k, v, h))
    weights = pad_layer_weights(weights, c)
    expect_aligned({"q": q, "k": k, "v": v})
    w, half = h.shape[-1], weights[5].shape[0]
    out = torch.empty_like(h)
    ws = None if w == C_KERNEL else torch.empty((b, n, w + 2 * half), dtype=torch.float32,
                                                device=h.device)
    attn_mlp_residual.launches += 1
    _build.launch("encoder_layer", "attn_mlp_residual", h.device,
                  kscale.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  compat.data_ptr(), _ptr(kbias), h.data_ptr(),
                  *(t.data_ptr() for t in weights[4:]), out.data_ptr(), _ptr(ws), b, n, w, half,
                  qk_scale(c))
    return unpad_channels(out, c)


attn_mlp_residual.launches = 0


def fused_layer(x, compat, kbias, weights, workspace=None):
    """The JAX dispatch: one launch up to ``MAX_FUSED_LAYER_N``, the pair
    above it, and the pair at every N for a layer wider than 128 channels."""
    if x.shape[1] <= MAX_FUSED_LAYER_N and padded_width(x.shape[-1]) == C_KERNEL:
        return fused_encoder_layer(x, compat, kbias, weights, workspace)
    h, q, k, v, kscale = pcn_qkv(x, weights, workspace)
    return attn_mlp_residual(kscale, q, k, v, compat, kbias, h, weights)


def make_fused_layer_fn(compat_cache, mask=None, fold_cache: dict | None = None):
    """The per-layer hook of ``NonLocalNet.forward(fused_layer_fn=...)``:
    fn(x, pcn_params, nl_params) -> x over the shared [B, N, N] int8 cache.
    With ``mask=None`` no key bias is read (all keys valid). ``fold_cache``:
    see ``folded_weights``; without it the BatchNorms are folded per call. On
    the card the layers share one workspace (h, q, k, v, kscale at
    ``padded_width(C)``), allocated at the first layer."""
    b, n = compat_cache.shape[:2]
    kbias = None if mask is None else key_bias(mask, b, n, compat_cache.device)
    workspace = []

    def layer_fn(x, pcn_params, nl_params):
        weights = folded_weights(pcn_params, nl_params, fold_cache)
        x = x.float().contiguous()
        if not workspace and on_cuda(x):
            workspace.extend(new_workspace(b, n, padded_width(x.shape[-1]), x.device))
        return fused_layer(x, compat_cache, kbias, weights, workspace or None)

    return layer_fn
