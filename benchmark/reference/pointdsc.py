"""Plain PyTorch reference of PointDSC (CVPR'21), written from the published
description and the reference code's semantics: the eval forward with its
seed stage and post-refinement. Dense matrices, no
kernels, no cache; float32 with TF32 off unless a lower precision is asked
for (the benchmark's control).

It imports nothing of the program under test: it takes a state dict of
tensors under the module names of the checkpoint (``encoder.layer0.weight``,
``encoder.PointCN_layer_{i}.Dense_0.weight``, ...) and raw numpy pairs,
and works out everything else (padding, masks, the compatibility matrix)
itself; BatchNorm takes the checkpoint's running statistics.

Precision (``lowp``): the eval forward's control computes every float32
stage in bfloat16, the attention's two N^2 C products on float8 (e4m3)
operands, scaled per tensor (per row for the weights p) as an fp8 kernel
would, and the compatibility matrix on 15 levels (int4) where the program
keeps 127 (int8): each one step below what the configuration states.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_NEG = -1e9
_BN_EPS = 1e-5
_FP8_MAX = 448.0


@contextlib.contextmanager
def full_f32():
    """Float32 products in full float32, TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- rounding

def _bf16(x, lowp):
    return x.to(torch.bfloat16).float() if lowp else x


def _fp8(x, dim=None):
    """x rounded to e4m3 after scaling its largest magnitude (per tensor, or
    along ``dim``) to the format's largest value."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = _FP8_MAX / torch.clamp(amax, min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _levels(c, lowp):
    return torch.round(c * 15.0) / 15.0 if lowp else c


# ---------------------------------------------------------------- pieces

def pad_pair(sample: dict, bucket: int, device) -> dict:
    """One pair as [1, bucket, ...] tensors with a validity mask."""
    n = sample["corr_pos"].shape[0]
    out = {}
    for key in ("corr_pos", "src_keypts", "tgt_keypts"):
        a = np.zeros((bucket,) + sample[key].shape[1:], np.float32)
        a[:n] = sample[key]
        out[key] = torch.as_tensor(a, device=device)[None]
    out["mask"] = (torch.arange(bucket, device=device) < n)[None]
    return out


def distances(x):
    """Exact Euclidean distances [B, N, N] in the difference form."""
    sq = 0.0
    for c in range(3):
        d = x[..., :, None, c] - x[..., None, :, c]
        sq = sq + d * d
    return torch.sqrt(sq)


def compat_matrix(src, tgt, mask, sigma_d):
    """clamp(1 - (d_src - d_tgt)^2 / sigma_d^2, 0) with invalid rows and
    columns zeroed, [B, N, N]."""
    diff = distances(src) - distances(tgt)
    compat = torch.clamp(1.0 - diff * diff / (sigma_d * sigma_d), min=0.0)
    return compat * (mask[:, :, None] & mask[:, None, :]).float()


def linear(sd, name, x, lowp=False):
    y = x @ sd[f"{name}.weight"].t() + sd[f"{name}.bias"]
    return _bf16(y, lowp)


def bn(sd, name, x, lowp=False):
    """Eval-mode BatchNorm on the running statistics."""
    mean, var = sd[f"{name}.running_mean"], sd[f"{name}.running_var"]
    a = sd[f"{name}.weight"] / torch.sqrt(var + _BN_EPS)
    return _bf16(x * a + (sd[f"{name}.bias"] - mean * a), lowp)


def attention(q, k, v, compat, mask, lowp=False):
    """softmax(compat * q k^T / sqrt(C), valid keys) v, [B, N, C]."""
    c = q.shape[-1]
    if lowp:
        q, k, v = _fp8(q), _fp8(k), _fp8(v)
    logits = torch.einsum("bnc,bmc->bnm", q, k) / (c ** 0.5)
    scores = torch.where(mask[:, None, :], compat * logits, torch.full_like(logits, _NEG))
    p = torch.softmax(scores, dim=-1)
    if lowp:
        p = _fp8(p, dim=-1)
    return _bf16(torch.einsum("bnm,bmc->bnc", p, v), lowp)


def encoder(sd, corr_pos, compat, mask, num_layers, lowp=False):
    """Input lift and num_layers x (PointCN, non-local attention, message
    MLP, residual); [B, N, C]."""
    x = linear(sd, "encoder.layer0", corr_pos, lowp)
    for i in range(num_layers):
        p, nl = f"encoder.PointCN_layer_{i}", f"encoder.NonLocal_layer_{i}"
        x = torch.relu(bn(sd, f"{p}.MaskedBatchNorm_0", linear(sd, f"{p}.Dense_0", x, lowp),
                          lowp))
        q = linear(sd, f"{nl}.projection_q", x, lowp)
        k = linear(sd, f"{nl}.projection_k", x, lowp)
        v = linear(sd, f"{nl}.projection_v", x, lowp)
        msg = attention(q, k, v, compat, mask, lowp)
        msg = torch.relu(bn(sd, f"{nl}.fc_message_bn0", linear(sd, f"{nl}.fc_message_0", msg,
                                                                 lowp), lowp))
        msg = torch.relu(bn(sd, f"{nl}.fc_message_bn1", linear(sd, f"{nl}.fc_message_1", msg,
                                                                 lowp), lowp))
        x = x + linear(sd, f"{nl}.fc_message_2", msg, lowp)
    return x


def confidence(sd, feats, lowp=False):
    x = torch.relu(linear(sd, "classification_0", feats, lowp))
    x = torch.relu(linear(sd, "classification_1", x, lowp))
    return linear(sd, "classification_2", x, lowp)[..., 0]


def normalize(feats):
    return feats / torch.sqrt(torch.sum(feats * feats, dim=-1, keepdim=True) + 1e-12)


def rigid_fit(src, tgt, w):
    """Weighted least-squares rigid transform src -> tgt by SVD with the
    reflection fix (the reference's ``rigid_transform_3d``), in float64.
    src, tgt [..., K, 3], w [..., K] -> [..., 4, 4] float32."""
    src, tgt, w = src.double(), tgt.double(), torch.clamp(w.double(), min=0.0)
    wsum = w.sum(-1, keepdim=True) + 1e-6
    cs = (src * w[..., None]).sum(-2) / wsum
    ct = (tgt * w[..., None]).sum(-2) / wsum
    h = torch.einsum("...ki,...k,...kj->...ij", src - cs[..., None, :], w, tgt - ct[..., None, :])
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    d = torch.where(d == 0, torch.ones_like(d), d)
    diag = torch.ones(h.shape[:-1], dtype=h.dtype, device=h.device)
    diag[..., 2] = d
    r = v @ torch.diag_embed(diag) @ u.transpose(-1, -2)
    t = ct - torch.einsum("...ij,...j->...i", r, cs)
    out = torch.zeros(h.shape[:-2] + (4, 4), dtype=h.dtype, device=h.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out.float()


def apply(trans, pts):
    return pts @ trans[..., :3, :3].transpose(-1, -2) + trans[..., None, :3, 3]


def nms_seeds(src, scores, mask, radius, num):
    """Seeds [B, num]: local maxima of the scores within ``radius`` (ties
    kept), ordered by score * flag, invalid points last, ties to the lower
    index."""
    d = distances(src)
    d = torch.where(mask[:, None, :], d, torch.full_like(d, float("inf")))
    s = torch.where(mask, scores, torch.full_like(scores, _NEG))
    free = (s[:, :, None] >= s[:, None, :]) | (d >= radius)
    flag = free.all(dim=-1).float()
    key = torch.where(mask, scores * flag, torch.full_like(scores, -float("inf")))
    # +0.0 sorts above -0.0 (a suppressed point keeps its score's sign)
    bits = key.contiguous().view(torch.int32)
    order_key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(order_key, dim=-1, descending=True, stable=True).indices[:, :num]


def seed_knn(normed, seeds, mask, k):
    """[B, S, k] nearest neighbours in feature space (2 - 2 f.f); the seed
    itself and invalid points last, ties to the lower index."""
    sf = torch.gather(normed, 1, seeds[..., None].expand(-1, -1, normed.shape[-1]))
    d = 2.0 - 2.0 * torch.einsum("bsc,bnc->bsn", sf, normed)
    cols = torch.arange(normed.shape[1], device=normed.device)
    far = (cols[None, None, :] == seeds[..., None]) | ~mask[:, None, :]
    d = torch.where(far, torch.full_like(d, 1e9), d)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def seed_hypotheses(normed, knn, src, tgt, mask, sigma, sigma_d, iters):
    """Each seed's transform [B, S, 4, 4]: the neighbours' feature and
    spatial compatibility, its leading eigenvector by power iteration, the
    weighted rigid fit."""
    b, s, k = knn.shape
    flat = knn.reshape(b, -1)

    def take(x):
        return torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1])).reshape(
            b, s, k, x.shape[-1])

    f, ps, pt = take(normed), take(src), take(tgt)
    km = torch.gather(mask, 1, flat).reshape(b, s, k)
    fm = torch.clamp(1.0 - (1.0 - f @ f.transpose(-1, -2)) / (sigma * sigma), min=0.0)
    sd = distances(ps) - distances(pt)
    sm = torch.clamp(1.0 - sd * sd / (sigma_d * sigma_d), min=0.0)
    m = fm * sm * (1.0 - torch.eye(k, device=f.device))
    m = m * (km[..., :, None] & km[..., None, :]).float()
    v = torch.ones(m.shape[:-1] + (1,), device=m.device)
    for _ in range(iters):
        w = m @ v
        v = w / (torch.sqrt(torch.sum(w * w, dim=-2, keepdim=True) + 1e-30) + 1e-6)
    w = torch.abs(v[..., 0]) * km
    w = w / (w.sum(-1, keepdim=True) + 1e-6)
    return rigid_fit(ps, pt, w)


def select(hyps, seeds, src, tgt, mask, thr):
    """The hypothesis with most inliers (first of equals; an invalid seed
    scores -1) and its inlier labels."""
    d2 = torch.sum((apply(hyps, src[:, None]) - tgt[:, None]) ** 2, dim=-1)  # [B, S, N]
    counts = ((d2 < thr * thr) & mask[:, None, :]).float().sum(-1)
    fit = counts / torch.clamp(mask.sum(-1, keepdim=True), min=1).float()
    fit = torch.where(torch.gather(mask, 1, seeds), fit, torch.full_like(fit, -1.0))
    best = torch.argmax(fit, dim=-1)
    trans = hyps[torch.arange(hyps.shape[0]), best]
    labels = ((torch.linalg.norm(apply(trans, src) - tgt, dim=-1) < thr) & mask).float()
    return trans, labels


def refine(trans, src, tgt, mask, thr, rounds):
    """Up to ``rounds`` rounds of inliers and a Geman-McClure weighted fit;
    a sample stops once its inlier count no longer changes."""
    prev = torch.zeros(trans.shape[0], device=trans.device)
    active = torch.ones(trans.shape[0], dtype=torch.bool, device=trans.device)
    for _ in range(rounds):
        d = torch.linalg.norm(apply(trans, src) - tgt, dim=-1)
        inl = (d < thr) & mask
        num = inl.float().sum(-1)
        active = active & (torch.abs(num - prev) >= 1)
        new = rigid_fit(src, tgt, inl.float() / (1.0 + (d / thr) ** 2))
        trans = torch.where(active[:, None, None], new, trans)
        prev = num
    return trans


# ---------------------------------------------------------------- entries

@torch.no_grad()
def eval_forward(sd: dict, sample: dict, cfg: dict, bucket: int, device, lowp=False) -> dict:
    """The eval forward on one raw pair, padded to ``bucket`` as the
    program's Evaluator pads it: (final transform [4, 4], the pre-refinement
    winner's labels [n], confidence logits [n]) as numpy arrays."""
    n = sample["corr_pos"].shape[0]
    x = pad_pair(sample, bucket, device)
    src, tgt, mask = x["src_keypts"], x["tgt_keypts"], x["mask"]
    with full_f32():
        compat = _levels(compat_matrix(src, tgt, mask, cfg["sigma_d"]), lowp)
        feats = encoder(sd, x["corr_pos"], compat, mask, cfg["num_layers"], lowp=lowp)
        del compat
        normed = normalize(feats)
        conf = confidence(sd, feats, lowp)
        seeds = nms_seeds(src, conf, mask, cfg["nms_radius"], max(1, int(bucket * cfg["ratio"])))
        knn = seed_knn(normed, seeds, mask, min(cfg["k"], bucket - 1))
        hyps = seed_hypotheses(normed, knn, src, tgt, mask, sd["sigma"], cfg["sigma_d"],
                               cfg["num_iterations"])
        trans, labels = select(hyps, seeds, src, tgt, mask, cfg["inlier_threshold"])
        thr = 0.10 if cfg["inlier_threshold"] == 0.10 else 1.2
        trans = refine(trans, src, tgt, mask, thr, cfg["refine_iters"])
    return {"trans": trans[0].cpu().numpy(), "labels": labels[0, :n].cpu().numpy(),
            "confidence": conf[0, :n].float().cpu().numpy()}
