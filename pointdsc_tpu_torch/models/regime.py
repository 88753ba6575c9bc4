"""Offset-softmax validity-regime check (counterpart of
``pointdsc_tpu/models/regime.py``).

The default eval kernels (kernels/encoder_layer.py and the offset attention
of kernels/sc_attention.py) replace the running max of the softmax with a
per-row upper bound on the logits, o_i = ||q_i|| * max_j ||k_j|| / sqrt(C),
and floor the exponent at -80 nats. That is exact to f32 resolution while
the bound's slack (o_i - max_j s_ij) stays under ~80 nats: true for
checkpoints trained here (BatchNorm keeps activation norms small, the slack
is a few nats), but a checkpoint imported from elsewhere carries no such
guarantee, and out-of-regime rows degrade silently toward uniform attention.

This module measures the slack of a (model, pair) by replaying the encoder
densely in eval-mode math, chunked over query rows so that nothing [N, N]
exists, and ``select_attention_kernels`` switches a model whose slack leaves
the regime to the running-max kernel, which is exact for any weights.
"""

from __future__ import annotations

import copy

import torch

from pointdsc_tpu_torch._device import full_f32_matmul

# the kernels floor the exponent at -80 nats; 60 leaves 20 nats of margin for
# pair-to-pair variation beyond the probed pairs and for the int8 cache's
# quantisation, which the dense replay does not model
OFFSET_REGIME_MAX_SLACK = 60.0
_BN_EPS = 1e-5


def _bn_eval(x, scale, bias, mean, var):
    """Eval-mode BatchNorm: y = x a + (b - mean a), a = scale / sqrt(var + eps)."""
    a = scale / torch.sqrt(var + _BN_EPS)
    return x * a + (bias - mean * a)


def _layer_params(encoder):
    """The encoder's parameters as per-layer dicts of raw tensors, Dense
    weights transposed to [in, out]."""
    def dense(w, b):
        return w.t(), b

    layers = []
    for i in range(encoder.num_layers):
        (w1, b1, bn1), nl = encoder.layer_params(i)
        (wq, bq, wk, bk, wv, bv, wm0, bm0, bn_m0, wm1, bm1, bn_m1, wm2, bm2) = nl
        layers.append({
            "pc_dense": dense(w1, b1), "pc_bn": bn1,
            "q": dense(wq, bq), "k": dense(wk, bk), "v": dense(wv, bv),
            "m0": dense(wm0, bm0), "bn0": bn_m0,
            "m1": dense(wm1, bm1), "bn1": bn_m1,
            "m2": dense(wm2, bm2),
        })
    return {"layer0": dense(encoder.layer0.weight, encoder.layer0.bias), "layers": layers}


def _encoder_slack(pt, src, tgt, sigma_d, corr_pos, mask, chunk):
    """Max over layers and valid rows of (offset_i - max_j s_ij) for one
    pair, with the kernels' own bound: q and k rounded to bf16, kmax over all
    rows (padding only loosens the bound), the row max over valid keys only
    (the kernels zero masked keys outright). Returns a 0-d tensor."""
    k0, b0 = pt["layer0"]
    x = corr_pos @ k0 + b0
    n, c = x.shape
    sqrt_c = c ** 0.5
    neg_inf = torch.tensor(-float("inf"), device=x.device)
    s_sq, t_sq = torch.sum(src ** 2, -1), torch.sum(tgt ** 2, -1)

    def compat_rows(lo):
        """[chunk, N] block of the spatial-consistency matrix."""
        rows = slice(lo, lo + chunk)
        d_s = torch.sqrt(torch.clamp(s_sq[rows, None] + s_sq[None, :]
                                     - 2.0 * (src[rows] @ src.t()), min=0.0))
        d_t = torch.sqrt(torch.clamp(t_sq[rows, None] + t_sq[None, :]
                                     - 2.0 * (tgt[rows] @ tgt.t()), min=0.0))
        diff = d_s - d_t
        cmp_ = torch.clamp(1.0 - diff * diff / (sigma_d * sigma_d), min=0.0)
        return torch.where(mask[rows, None] & mask[None, :], cmp_, torch.zeros_like(cmp_))

    worst = neg_inf
    for lp in pt["layers"]:
        x = torch.relu(_bn_eval(x @ lp["pc_dense"][0] + lp["pc_dense"][1], *lp["pc_bn"]))
        # the kernels' bf16 q/k streams: norms and logits of what the card sees
        q = (x @ lp["q"][0] + lp["q"][1]).to(torch.bfloat16).float()
        k = (x @ lp["k"][0] + lp["k"][1]).to(torch.bfloat16).float()
        v = x @ lp["v"][0] + lp["v"][1]
        kmax = torch.sqrt(torch.amax(torch.sum(k * k, dim=-1)))
        outs = []
        for lo in range(0, n, chunk):
            rows = q[lo:lo + chunk]
            s = compat_rows(lo) * ((rows @ k.t()) / sqrt_c)
            s = torch.where(mask[None, :], s, neg_inf)
            off = torch.sqrt(torch.sum(rows * rows, dim=-1)) * (kmax / sqrt_c)
            slack = torch.where(mask[lo:lo + chunk], off - torch.amax(s, dim=-1), neg_inf)
            worst = torch.maximum(worst, torch.amax(slack))
            # continue the trunk with the exact attention, so that later
            # layers see true activations
            outs.append(torch.softmax(s, dim=-1) @ v)
        o = torch.cat(outs, dim=0)
        msg = torch.relu(_bn_eval(o @ lp["m0"][0] + lp["m0"][1], *lp["bn0"]))
        msg = torch.relu(_bn_eval(msg @ lp["m1"][0] + lp["m1"][1], *lp["bn1"]))
        x = x + (msg @ lp["m2"][0] + lp["m2"][1])
    return worst


@torch.no_grad()
@full_f32_matmul()
def offset_regime_slack(model, corr_pos, src_keypts, tgt_keypts, mask=None,
                        chunk: int = 1024) -> float:
    """Worst offset-softmax bound slack (nats) of this model on this pair,
    over all encoder layers; batched inputs [B, N, ...] are reduced over the
    batch. In regime iff < ``OFFSET_REGIME_MAX_SLACK``. Inputs are tensors on
    the model's device; the result is read back once."""
    pt = _layer_params(model.encoder)
    n = corr_pos.shape[1]
    chunk = min(chunk, n)
    while n % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones(corr_pos.shape[:2], dtype=torch.bool, device=corr_pos.device)
    worst = [
        _encoder_slack(pt, src_keypts[b].float(), tgt_keypts[b].float(), float(model.sigma_d),
                       corr_pos[b].float(), mask[b], chunk)
        for b in range(corr_pos.shape[0])
    ]
    return float(torch.amax(torch.stack(worst)))


def select_attention_kernels(model, corr_pos, src_keypts, tgt_keypts, mask=None,
                             context: str = "eval"):
    """Kernel selection at checkpoint-load time: returns ``(model, slack,
    flipped)``. The model comes back unchanged while the slack on the probe
    pair stays inside the regime; once it leaves it, a shallow copy that
    shares the parameters and has ``offset_softmax=False`` (the running-max
    kernel, exact for any weights) comes back with ``flipped`` True. The
    slack depends on the pair, so callers probe several (the Evaluator probes
    the first few and the first of every bucket). No-op (slack 0.0) for a
    model that already runs the running-max kernel."""
    if not model.offset_softmax:
        return model, 0.0, False
    slack = offset_regime_slack(model, corr_pos, src_keypts, tgt_keypts, mask=mask)
    if slack >= OFFSET_REGIME_MAX_SLACK:
        print(f"[{context}] offset-softmax bound slack {slack:.1f} nats is outside the "
              f"{OFFSET_REGIME_MAX_SLACK:.0f}-nat validity regime (unconstrained or imported "
              "weights, or an out-of-distribution pair): selecting the running-max "
              "attention kernel instead")
        flipped = copy.copy(model)  # shares parameters and submodules
        flipped.offset_softmax = False
        return flipped, slack, True
    return model, slack, False
