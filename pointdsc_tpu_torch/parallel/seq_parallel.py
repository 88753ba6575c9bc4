"""Sequence-parallel (row-sharded) PointDSC inference over a device mesh
(PyTorch counterpart of ``pointdsc_tpu/parallel/seq_parallel.py``).

The O(N^2) objects of one pair, the spatial-consistency matrix and each
attention layer's logits, are sharded over the mesh's correspondence rows:
shard i owns rows [i N/D, (i + 1) N/D) of the compat matrix and of every
layer's attention, and only O(N C) objects (keys, values, coordinates and
masks) are gathered from all shards:

    rows_loc     = N / D                          (the caller pads N)
    compat_loc   = clamp(1 - (|d_src| - |d_tgt|)^2 / sigma_d^2)  [B, rows_loc, N]
    per layer:   PointCN (eval BN)                 local rows
                 q_loc; k, v gathered -> [B, N, C]
                 softmax(compat_loc * q_loc k^T / sqrt(C)) v    local rows
    features     [B, N, C], the shards concatenated on mesh[0]

The shards advance layer by layer in lockstep, as JAX's ``shard_map`` over a
single-controller mesh runs them: one process queues every shard's layer
before the gather. On a mesh of several cards each shard runs on its own
card, asynchronously, and the gather copies the shards' k and v between
them; a mesh that names one card D times runs the D shards on it in turn.

``sp_encode`` is the dense-semantics encoder in plain PyTorch (f32, eval
BatchNorm). ``sp_encode_fused`` is the production one: each shard builds
only its [B, N/D, N] slice of the int8 cache (the rectangular
``build_compat_cache_int8``) and streams it through the cached attention of
the model's current softmax form (the rectangular offset kernel, or the
running max once the Evaluator's regime guard has flipped the model), with
q, k and v rounded to bf16 on the card before the gather (on the CPU they
stay f32, as in JAX's interpret mode). The tail (confidence, NMS, seed
stage, refinement) runs through the model itself with
``precomputed_features`` (``sp_testing_forward``).
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch._device import full_f32_matmul
from pointdsc_tpu_torch.kernels.sc_attention import (
    build_compat_cache_int8,
    fused_sc_attention_cached,
)
from pointdsc_tpu_torch.models.regime import _bn_eval, _layer_params
from pointdsc_tpu_torch.ops.knn import pairwise_dists_exact

_NEG_INF = -1e9


def _row_shards(mesh, corr_pos, src_keypts, tgt_keypts, mask):
    """Each mesh entry's rows of the four inputs, on its device:
    [(corr_pos, src, tgt, mask)] * D. N must divide the mesh."""
    bsz, n = corr_pos.shape[:2]
    d = len(mesh)
    if n % d != 0:
        raise ValueError(f"N={n} must divide the 'sp' mesh axis ({d})")
    if mask is None:
        mask = torch.ones((bsz, n), dtype=torch.bool, device=corr_pos.device)
    n_loc = n // d
    return [tuple(t[:, i * n_loc:(i + 1) * n_loc].to(dev)
                  for t in (corr_pos.float(), src_keypts.float(), tgt_keypts.float(), mask))
            for i, dev in enumerate(mesh)]


def _gather(mesh, parts):
    """The shards' [B, n_loc, ...] tensors concatenated along the rows on
    every mesh entry's device (once per distinct device): [B, N, ...] * D."""
    full = {}
    for dev in mesh:
        if dev not in full:
            full[dev] = torch.cat([p.to(dev) for p in parts], dim=1)
    return [full[dev] for dev in mesh]


def _params_on(mesh, encoder):
    """``_layer_params(encoder)`` on each mesh entry's device (copied once per
    distinct device)."""
    pt = _layer_params(encoder)
    per = {}
    for dev in mesh:
        if dev not in per:
            per[dev] = _tree_to(pt, dev)
    return [per[dev] for dev in mesh]


def _tree_to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev)
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return type(tree)(_tree_to(v, dev) for v in tree)


def _pointcn(x, lp):
    kp, bp = lp["pc_dense"]
    return torch.relu(_bn_eval(x @ kp + bp, *lp["pc_bn"]))


def _message_mlp(x, msg, lp):
    """The message MLP (C -> C/2 -> C/2 -> C) and the residual, local rows."""
    km0, bm0 = lp["m0"]
    msg = torch.relu(_bn_eval(msg @ km0 + bm0, *lp["bn0"]))
    km1, bm1 = lp["m1"]
    msg = torch.relu(_bn_eval(msg @ km1 + bm1, *lp["bn1"]))
    km2, bm2 = lp["m2"]
    return x + (msg @ km2 + bm2)


def _qkv(x, lp):
    return tuple(x @ lp[name][0] + lp[name][1] for name in ("q", "k", "v"))


@torch.no_grad()
@full_f32_matmul()
def sp_encode(model, corr_pos, src_keypts, tgt_keypts, mesh, mask=None) -> torch.Tensor:
    """Row-sharded encoder forward (eval mode, dense semantics). Inputs
    [B, N, in_dim], [B, N, 3] x 2, mask [B, N] bool or None; ``mesh`` a list
    of devices (parallel/mesh.py). Returns the un-normalised features
    [B, N, C] on ``mesh[0]``. N must divide len(mesh) (pad and mask
    otherwise, as the data layer's buckets do)."""
    shards = _row_shards(mesh, corr_pos, src_keypts, tgt_keypts, mask)
    params = _params_on(mesh, model.encoder)
    sigma_d = float(model.sigma_d)
    s_full = _gather(mesh, [s for _, s, _, _ in shards])
    t_full = _gather(mesh, [t for _, _, t, _ in shards])
    m_full = _gather(mesh, [m for _, _, _, m in shards])

    xs, compats = [], []
    for i, (cp, s, t, m) in enumerate(shards):
        diff = pairwise_dists_exact(s, s_full[i]) - pairwise_dists_exact(t, t_full[i])
        compat = torch.clamp(1.0 - diff * diff / (sigma_d * sigma_d), min=0.0)
        compats.append(torch.where(m[..., :, None] & m_full[i][..., None, :], compat,
                                   torch.zeros_like(compat)))  # [B, n_loc, N]
        k0, b0 = params[i]["layer0"]
        xs.append(cp @ k0 + b0)
    c = xs[0].shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(c)))  # JAX's f32 1/sqrt(C)

    for li in range(len(params[0]["layers"])):
        qkv = []
        for i in range(len(mesh)):
            lp = params[i]["layers"][li]
            xs[i] = _pointcn(xs[i], lp)
            qkv.append(_qkv(xs[i], lp))
        k_full = _gather(mesh, [k for _, k, _ in qkv])
        v_full = _gather(mesh, [v for _, _, v in qkv])
        for i in range(len(mesh)):
            q = qkv[i][0]
            logits = torch.einsum("bnc,bmc->bnm", q, k_full[i]) * scale
            scores = compats[i] * logits
            scores = torch.where(m_full[i][:, None, :], scores, torch.full_like(scores, _NEG_INF))
            w = torch.softmax(scores, dim=-1)
            msg = torch.einsum("bnm,bmc->bnc", w, v_full[i])
            xs[i] = _message_mlp(xs[i], msg, params[i]["layers"][li])
    return torch.cat([x.to(mesh[0]) for x in xs], dim=1)


@torch.no_grad()
@full_f32_matmul()
def sp_encode_fused(model, corr_pos, src_keypts, tgt_keypts, mesh, mask=None) -> torch.Tensor:
    """Production sequence-parallel encoder: the layout of ``sp_encode``,
    each shard's compat rows as its [B, N/D, N] int8 cache slice (one launch
    of the rectangular cache kernel a shard) streamed through the cached
    attention of the model's ``offset_softmax`` (one launch a shard and
    layer: the rectangular kernel where N/D != N). On the card q, k and v are
    rounded to bf16 before the gather, which halves the bytes it moves; on
    the CPU the plain versions run in f32. Returns [B, N, C] on ``mesh[0]``."""
    shards = _row_shards(mesh, corr_pos, src_keypts, tgt_keypts, mask)
    params = _params_on(mesh, model.encoder)
    sigma_d = float(model.sigma_d)
    offset = bool(getattr(model, "offset_softmax", True))
    s_full = _gather(mesh, [s for _, s, _, _ in shards])
    t_full = _gather(mesh, [t for _, _, t, _ in shards])
    m_full = _gather(mesh, [m for _, _, _, m in shards])

    xs, caches = [], []
    for i, (cp, s, t, _m) in enumerate(shards):
        caches.append(build_compat_cache_int8(s, t, sigma_d, mask=m_full[i], src_cols=s_full[i],
                                              tgt_cols=t_full[i]))  # [B, n_loc, N] int8
        k0, b0 = params[i]["layer0"]
        xs.append(cp @ k0 + b0)

    for li in range(len(params[0]["layers"])):
        qkv = []
        for i, dev in enumerate(mesh):
            lp = params[i]["layers"][li]
            xs[i] = _pointcn(xs[i], lp)
            q, k, v = _qkv(xs[i], lp)
            if dev.type == "cuda":  # the kernels' bf16 streams, rounded before the gather
                q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
            qkv.append((q, k, v))
        k_full = _gather(mesh, [k for _, k, _ in qkv])
        v_full = _gather(mesh, [v for _, _, v in qkv])
        for i in range(len(mesh)):
            msg = fused_sc_attention_cached(qkv[i][0].contiguous(), k_full[i], v_full[i],
                                            caches[i], s_full[i], t_full[i], mask=m_full[i],
                                            offset_softmax=offset)
            xs[i] = _message_mlp(xs[i], msg, params[i]["layers"][li])
    return torch.cat([x.to(mesh[0]) for x in xs], dim=1)


@torch.no_grad()
def sp_testing_forward(model, corr_pos, src_keypts, tgt_keypts, mesh, mask=None,
                       fused_tail: bool = True, fused_encoder: bool = False):
    """The testing-mode forward with the encoder row-sharded over ``mesh``:
    equal to ``model(..., testing=True)`` on one device up to the encoder's
    numerics. The O(S k) / O(N) tail runs through the model on its own
    device with ``precomputed_features``; ``fused_tail`` routes it through
    the kernels (at the N this path exists for, the dense tail's [B, S, N]
    seed distances would themselves be an O(N^2 / 10) object).
    ``fused_encoder`` takes ``sp_encode_fused`` instead of the
    dense-semantics ``sp_encode``."""
    encode = sp_encode_fused if fused_encoder else sp_encode
    features = encode(model, corr_pos, src_keypts, tgt_keypts, mesh, mask=mask)
    dev = corr_pos.device
    return model(corr_pos, src_keypts, tgt_keypts, mask=mask, testing=True, fused=fused_tail,
                 precomputed_features=features.to(dev))
