"""Kernel-only times of the attention loops, of the split PointCN + QKV
kernel, of the post-refinement, of the int8 cache build, of the seed NMS,
of the scoring kernel, of the confidence head, of the trainable attention
and of the nearest-neighbour search, on a CUDA card.

    python -m pointdsc_tpu_torch.tools.time_attention [--cases NAME,...] [--out FILE]

At N = 5120 and N = 12288 (C = 128, one pair, the last 5% of points padded):
CUDA events around each kernel that holds the two N^2 C attention products
(the attentions' private launches, no packing; the layer kernels' wrappers,
which only allocate their outputs; median of 10 after 2 warm-ups): the
running-max attention (bf16 inputs), the same loop without a cache (bf16
inputs, the compat tile from the packed geometry), the offset attention
(bf16 inputs, its kscale reduction included), the attention + MLP +
residual kernel, the PointCN + QKV kernel and, up to N = 6144, the
one-launch layer kernel.
``chip_smoke.py`` times the public wrappers; this tool separates the loops
from their wrappers' host work. Prints one JSON object per N.

Then, through the public wrappers only (so that the same file times another
tree's package: run it by path with that tree on ``PYTHONPATH``), one
object per case: the PointCN + QKV kernel at N = 12288 and 20480, and the
post-refinement at N = 5120 (a Synthetic pair, threshold 0.1), 12288 and
20480 (SyntheticKITTI-scale pairs, threshold 1.2), the last 5% of points
padded, the initial transform the ground truth moved by 3 cm, with the
rounds it ran; the int8 cache build (``build_compat_cache_int8``) and the
seed NMS (``pick_seeds_nms_prefiltered``: S = N / 10, normal scores, radius
0.1; the prefilter runs at 12288) on the same pairs at N = 5120 and 12288;
scoring (``seed_inlier_counts``, S = 512 transforms near the ground truth)
at N = 5120 and the confidence head at N = 5120, 12288 and 20480; the seed stage
after the seed k-NN (``seed_hypotheses``: ``data.synthetic.seed_stage_inputs``,
S = N / 10, k = 40, at N = 5120 in a 2 m cube and 12288 in a 100 m one, each
of its three kernels in ``kernels_ms``); the trainable attention's three
kernels (``train_attention``: forward with the LSE, backward dQ, backward
dK, dV, each through its public entry) and the two SM-loss kernels (sums,
grads) at bs 16 / N = 1024 (1000 correspondences a pair, 24 padded;
sigma_d 0.1) and at 1 x 12288 in the KITTI regime (sigma_d 1.2, 50 m pairs),
each kernel's time beside its bound (``kernels/sc_attention.py::
train_attention_work`` and ``kernels/sm_loss.py::sm_loss_work`` at
67 TFLOP/s f32 and 3.35 TB/s; a tree without them gives no bound); the
nearest-neighbour search of ICP (``nn_search``: ``nearest_neighbors`` at
N = M = 2048, 5120 and 20480, a base cloud in a 3 m cube and each query a
base point moved by ~1 cm) beside its bound and its issue floor
(``kernels/nn_search.py::nn_search_work``, ``nn_issue_floor_ms``; not in a
tree without them); the two int8 cache kernels (``symcache``: the symmetric
and the full-grid kernel, each through its launch, the symmetric wrapper and
the production wrapper with the route it took, at SYM_SIZES, beside the
bound of ``kernels/sc_attention.py::compat_cache_work``); the symmetric
kernel's plan at three diagonal weights against the full-grid kernel
(``symcache_weights``, rounds alternating them, at SYM_WEIGHT_SIZES).
``wrapper_ms``: CUDA events around one wrapper call; ``kernel_ms``: the
kernel's own device time per call from ``torch.profiler``
(``profile_forward``'s device summary over 20 calls; the seed NMS's
kernels each in ``kernels_ms``), beside all the call's device
operations (``device_ops``, ``device_ms``); PointCN + QKV also with its two
products as ``torch.addmm`` in f32 (TF32 off): two calls, the products only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import torch

from pointdsc_tpu_torch.data import SyntheticPairDataset, collate_batch
from pointdsc_tpu_torch.kernels import conf_mlp as kconf
from pointdsc_tpu_torch.kernels import encoder_layer as kenc
from pointdsc_tpu_torch.kernels import nms as knms
from pointdsc_tpu_torch.kernels import nn_search as knn
from pointdsc_tpu_torch.kernels import refine as kref
from pointdsc_tpu_torch.kernels import sc_attention as katt
from pointdsc_tpu_torch.kernels import scoring as kscore
from pointdsc_tpu_torch.kernels import sm_loss as ksm
from pointdsc_tpu_torch.tools.profile_forward import SNAPSHOTS, _device_profile

C = 128
# published H100 SXM peaks (NVIDIA data sheet): f32 CUDA-core FLOP/s, HBM bytes/s
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# the cache kernels' sizes: the standard N, the demo's ragged 5000, and the
# crossover between them
SYM_SIZES = (1000, 2048, 3072, 4096, 5000, 5120, 8192, 12288, 20480)
# symcache_weights: the diagonal band's weights the symmetric kernel's plan is
# timed at (``kernels/sc_attention.py::SYM_DIAGONAL_COST``, in SYM_BAND_COST
# units: 1.75, 1.9 and 2.0 bands), the rounds that alternate them with the
# full-grid kernel, and the sizes, the gate's crossover among them
SYM_WEIGHTS, SYM_WEIGHT_ROUNDS = (35, 38, 40), 4
SYM_WEIGHT_SIZES = (2048, 3072, 4096, 5000, 5120, 8192, 12288, 20480)
# the training shapes: n -> (batch, correspondences a pair, sigma_d, data)
TRAIN_SHAPES = {1024: (16, 1000, 0.1, {}), 12288: (1, 12288, 1.2, SNAPSHOTS["kitti"][2])}


def _event_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _layer_inputs(n, dev, gen):
    """A layer's ten random weights of scale 1/sqrt(C), and x [1, n, C]."""
    shapes = ((C, C), (C,), (C, 3 * C), (3 * C,), (C, C // 2), (C // 2,), (C // 2, C // 2),
              (C // 2,), (C // 2, C), (C,))
    weights = tuple((torch.randn(s, generator=gen) * C ** -0.5).to(dev) for s in shapes)
    return torch.randn((1, n, C), generator=gen).to(dev), weights


def _pair(n, dev):
    """One pair at N = n (SyntheticKITTI's data above 5120), the last 5%
    padded: src, tgt, mask, the ground truth."""
    ds_kw = {} if n <= 5120 else SNAPSHOTS["kitti"][2]
    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.4, seed=1, **ds_kw)[0]
    src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
    tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
    mask = (torch.arange(n) < n - n // 20)[None].to(dev)
    return src, tgt, mask, torch.as_tensor(ex["gt_trans"]).to(dev)


def _inputs(n, sigma_d, dev):
    src, tgt, mask, _ = _pair(n, dev)
    gen = torch.Generator().manual_seed(0)
    x, weights = _layer_inputs(n, dev, gen)
    qkv = [torch.randn((1, n, C), generator=gen).to(dev) for _ in range(3)]
    cache = katt.build_compat_cache_int8(src, tgt, sigma_d, mask=mask)
    return (x, weights, qkv, cache, katt.key_bias(mask, 1, n, dev),
            katt.pack_geometry(src, tgt, mask))


def _device_split(fn, *kernels):
    """Per call of fn: its device operations and device ms, the device ms of
    the operations whose name holds one of ``kernels`` (``kernel_ms``), and of
    each such operation (``kernels_ms``); "not measured" without device
    activity."""
    prof = _device_profile(fn, forwards=20)
    if prof["device_ms_per_forward"] == "not measured":
        return {"kernel_ms": "not measured", "device_ops": "not measured",
                "device_ms": "not measured"}
    mine = {op["name"]: op["ms_per_forward"] for op in prof["top_ops"]
            if any(k in op["name"] for k in kernels)}
    return {"kernel_ms": sum(mine.values()), "kernels_ms": mine,
            "device_ops": prof["device_ops_per_forward"],
            "device_ms": prof["device_ms_per_forward"]}


def cache_case(n, dev):
    src, tgt, mask, _ = _pair(n, dev)
    sigma_d = 0.1 if n <= 5120 else 1.2

    def call():
        return katt.build_compat_cache_int8(src, tgt, sigma_d, mask=mask)

    return {"kernel": "compat_cache_int8", "n": n, "wrapper_ms": _event_ms(call),
            **_device_split(call, "compat_cache_kernel", "compat_cache_sym_kernel")}


def symcache_case(n, dev):
    """The two cache kernels on one pair: the symmetric one and the full-grid
    one through their launches (no checks), each kernel only beside its
    wrapper time, then the production wrapper and the route it took."""
    from pointdsc_tpu_torch.kernels import symcache as ksym

    src, tgt, mask, _ = _pair(n, dev)
    sigma_d = 0.1 if n <= 5120 else 1.2
    coef = katt.cache_coef(sigma_d)
    b_, o_ = bound_ms(*katt.compat_cache_work(1, n))
    out = {"kernel": "compat_cache_int8_sym", "n": n, "bound_ms": b_, "bound_by": o_}
    for name, call, kernel in (
            ("sym", lambda: katt._launch_compat_cache_sym(src, tgt, coef), "compat_cache_sym_kernel"),
            ("full_grid", lambda: katt._launch_compat_cache(src, tgt, coef), "compat_cache_kernel"),
            ("sym_wrapper", lambda: ksym.build_compat_cache_int8_sym(src, tgt, sigma_d), None),
            ("production", lambda: katt.build_compat_cache_int8(src, tgt, sigma_d, mask=mask),
             None)):
        out[name] = {"wrapper_ms": _event_ms(call)}
        if kernel is not None:
            out[name].update(_device_split(call, kernel))
    out["production"]["route"] = "symmetric" if katt.use_symmetric_cache(n) else "full_grid"
    return out


def symcache_weights_case(n, dev):
    """The symmetric kernel under the plan of each diagonal weight of
    SYM_WEIGHTS (``SYM_DIAGONAL_COST`` set for the call, then restored) and
    the full-grid kernel, through their launches, in SYM_WEIGHT_ROUNDS rounds
    that alternate them. Each round is one profiler session of 20 calls; a
    session that recorded other than one device operation a call lost
    launches and is left out (``dropped``). Per variant: the kernel-only
    times of the rounds kept and their median; per weight the ratio of that
    median to the full grid's, and the plan's item count."""
    src, tgt, _, _ = _pair(n, dev)
    coef = katt.cache_coef(0.1 if n <= 5120 else 1.2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = [(w, "compat_cache_sym_kernel") for w in SYM_WEIGHTS]
    variants.append(("full_grid", "compat_cache_kernel"))
    times = {str(v): [] for v, _ in variants}
    dropped = {str(v): 0 for v, _ in variants}
    items = {}
    committed = katt.SYM_DIAGONAL_COST
    try:
        for _ in range(SYM_WEIGHT_ROUNDS):
            for v, kernel in variants:
                if v == "full_grid":
                    call = lambda: katt._launch_compat_cache(src, tgt, coef)
                else:
                    katt.SYM_DIAGONAL_COST = v
                    katt._symmetric_plan_on.cache_clear()
                    items[str(v)] = len(katt.symmetric_cache_plan(1, n, sms))
                    call = lambda: katt._launch_compat_cache_sym(src, tgt, coef)
                split = _device_split(call, kernel)
                if split["device_ops"] == 1.0:
                    times[str(v)].append(split["kernel_ms"])
                else:
                    dropped[str(v)] += 1
    finally:
        katt.SYM_DIAGONAL_COST = committed
        katt._symmetric_plan_on.cache_clear()
    median = {v: statistics.median(t) if t else "not measured" for v, t in times.items()}
    full = median["full_grid"]
    ratio = {str(w): (median[str(w)] / full if isinstance(median[str(w)], float)
                      and isinstance(full, float) else "not measured") for w in SYM_WEIGHTS}
    return {"kernel": "compat_cache_sym weights", "n": n, "band_cost": katt.SYM_BAND_COST,
            "committed_weight": committed, "plan_items": items, "kernel_ms": times,
            "median_ms": median, "over_full_grid": ratio, "dropped": dropped}


def nms_case(n, dev):
    src, _, mask, _ = _pair(n, dev)
    scores = torch.randn((1, n), generator=torch.Generator().manual_seed(3)).to(dev)

    def call():
        return knms.pick_seeds_nms_prefiltered(src, scores, 0.1, n // 10, mask=mask)

    return {"kernel": "seed NMS", "n": n, "s": n // 10, "wrapper_ms": _event_ms(call),
            **_device_split(call, "nms")}


def scoring_case(n, dev):
    src, tgt, mask, gt = _pair(n, dev)
    gen = torch.Generator().manual_seed(4)
    trans = gt.expand(1, 512, 4, 4).clone()
    trans[:, :, :3, 3] += 0.05 * torch.randn((1, 512, 3), generator=gen).to(dev)

    def call():
        return kscore.seed_inlier_counts(trans, src, tgt, 0.1, mask=mask)

    return {"kernel": "seed_inlier_counts", "n": n, "s": 512, "wrapper_ms": _event_ms(call),
            **_device_split(call, "scoring_kernel")}


def seed_stage_case(n, dev):
    from pointdsc_tpu_torch.data.synthetic import seed_stage_inputs
    from pointdsc_tpu_torch.kernels import seed_knn as kknn

    d = seed_stage_inputs(n, kitti=n > 5120)
    f, seeds, src, tgt, mask = (torch.as_tensor(d[k]).to(dev)
                                for k in ("feats", "seeds", "src", "tgt", "mask"))
    args = (f, seeds, kknn.seed_knn_exact(f, seeds, 40, mask=mask), src, tgt, mask,
            torch.full((1,), 0.8, device=dev), d["sigma_d"], d["inlier_threshold"], 10)

    def call():
        return kscore.seed_hypotheses(*args)

    return {"kernel": "seed_hypotheses", "n": n, "s": n // 10, "k": 40,
            "wrapper_ms": _event_ms(call),
            **_device_split(call, "hypotheses_kernel", "scoring_kernel", "select_kernel")}


def confidence_case(n, dev):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, n, C), generator=gen).to(dev)
    head = [(torch.randn(shape, generator=gen) * 0.2).to(dev)
            for shape in ((32, C), (32,), (32, 32), (32,), (1, 32), (1,))]

    # a tree from before the packed head takes the six tensors
    pack = getattr(kconf, "pack_head_weights", None)
    args = (x, pack(*head)) if pack else (x, *head)

    def call():
        return kconf.confidence_head(*args)

    return {"kernel": "confidence_head", "n": n, "wrapper_ms": _event_ms(call),
            **_device_split(call, "conf_mlp_kernel")}


def bound_ms(bytes_moved, ops):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory rate
    and f32 operations over the CUDA-core rate."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_attention_case(n, dev):
    bs, node, sigma_d, data = TRAIN_SHAPES[n]
    ds = SyntheticPairDataset(num_pairs=bs, num_corr=node, inlier_ratio=0.35, seed=3, **data)
    batch = collate_batch([ds[i] for i in range(bs)])
    src, tgt, mask, gt = (torch.as_tensor(batch[k]).to(dev)
                          for k in ("src_keypts", "tgt_keypts", "mask", "gt_labels"))
    gen = torch.Generator().manual_seed(4)
    q, k, v, d_out = (torch.randn((bs, n, C), generator=gen).to(dev) for _ in range(4))
    geom = katt.pack_geometry(src, tgt, mask)
    out, lse = katt.sc_attention_forward(q, k, v, geom, sigma_d)
    bwd = (q, k, v, geom, lse, torch.sum(d_out * out, dim=-1), d_out, sigma_d)
    # the SM loss as chip_smoke.py phase 12 feeds it: unit features, sigma 1.07
    f = torch.nn.functional.normalize(torch.randn((bs, n, C), generator=gen), dim=-1).to(dev)
    strips = ksm.pack_labels(gt, mask)
    wp, wn = ksm.balance_weights(strips, balanced=False)
    scalars = torch.stack([torch.full((bs,), 1.07, device=dev), wp, wn, torch.zeros_like(wp)],
                          dim=-1).contiguous()
    calls = {"forward": lambda: katt.sc_attention_forward(q, k, v, geom, sigma_d),
             "dq": lambda: katt.sc_attention_backward_dq(*bwd),
             "dkv": lambda: katt.sc_attention_backward_dkv(*bwd),
             "sums": lambda: ksm.sm_loss_sums(f, strips, scalars),
             "grads": lambda: ksm.sm_loss_grads(f, strips, scalars)}
    work = {}
    if hasattr(katt, "train_attention_work"):  # a tree from before it gives no bounds
        work = {**katt.train_attention_work(bs, n, C), **ksm.sm_loss_work(bs, n, C)}
    res = {"kernel": "train_attention", "bs": bs, "n": n, "padded": n - node}
    for name, call in calls.items():
        kernel = "sm_loss" if name in ("sums", "grads") else "sc_attention"
        res[name] = {"wrapper_ms": _event_ms(call), **_device_split(call, kernel)}
        if name in work:
            b, by = bound_ms(*work[name])
            res[name].update(bound_ms=b, bound_by=by)
            if res[name]["kernel_ms"] != "not measured":
                res[name]["kernel_over_bound"] = res[name]["kernel_ms"] / b
    return res


def nn_search_case(n, dev):
    gen = torch.Generator().manual_seed(6)
    base = torch.rand((n, 3), generator=gen) * 3.0
    pick = torch.randint(0, n, (n,), generator=gen)
    query = (base[pick] + 0.01 * torch.randn((n, 3), generator=gen)).to(dev)
    base = base.to(dev)

    def call():
        return knn.nearest_neighbors(query, base)

    res = {"kernel": "nearest_neighbors", "n": n, "m": n, "wrapper_ms": _event_ms(call),
           **_device_split(call, "nn_kernel")}
    if hasattr(knn, "nn_search_work"):  # a tree from before it gives no bound
        res["bound_ms"], res["bound_by"] = bound_ms(*knn.nn_search_work(1, n, n))
        res["issue_floor_ms"] = knn.nn_issue_floor_ms(1, n, n)
        if res["kernel_ms"] != "not measured":
            res["kernel_over_issue_floor"] = res["kernel_ms"] / res["issue_floor_ms"]
    return res


def pcn_qkv_case(n, dev):
    x, w = _layer_inputs(n, dev, torch.Generator().manual_seed(0))
    res = {"kernel": "pcn_qkv", "n": n, "wrapper_ms": _event_ms(lambda: kenc.pcn_qkv(x, w)),
           **_device_split(lambda: kenc.pcn_qkv(x, w), "pcn_qkv_kernel")}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x2, h2 = x.reshape(n, C), torch.empty((n, C), device=dev)

        def products():
            torch.addmm(w[1], x2, w[0], out=h2)
            return torch.addmm(w[3], h2, w[2])

        res["addmm_products_ms"] = _event_ms(products)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res


def refine_case(n, dev):
    thr = 0.1 if n <= 5120 else 1.2
    src, tgt, mask, gt = _pair(n, dev)
    init = gt[None].clone()
    init[:, :3, 3] += 0.03
    _, iters = kref.fused_post_refinement(init, src, tgt, mask, thr, 20, return_iters=True)

    def call():
        return kref.fused_post_refinement(init, src, tgt, mask, thr, 20)

    return {"kernel": "fused_post_refinement", "n": n, "thr": thr, "rounds": int(iters.sum()),
            "wrapper_ms": _event_ms(call), **_device_split(call, "refine_kernel")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--cases", default=None,
                    help="only these wrapper cases (e.g. confidence,seed_stage), no loops")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = []
    only = None if args.cases is None else {f"{c}_case" for c in args.cases.split(",")}
    for name, sigma_d in (() if only else (("synthetic", 0.1), ("kitti", 1.2))):
        n = SNAPSHOTS[name][1]
        x, w, (q, k, v), cache, kbias, geom = _inputs(n, sigma_d, dev)
        qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
        h, qb, kb, vb, kscale = kenc.pcn_qkv(x, w)
        res = {
            "card": card, "n": n,
            "running_max_ms": _event_ms(
                lambda: katt._launch_sc_attention(qh, kh, vh, cache, kbias, C)),
            "nocache_ms": _event_ms(
                lambda: katt._launch_sc_attention_nocache(qh, kh, vh, geom, sigma_d, C)),
            "offset_ms": _event_ms(
                lambda: katt._launch_sc_attention_offset(qh, kh, vh, cache, kbias, C)),
            "offset_kscale_reduction_ms": _event_ms(lambda: katt.offset_kscale(kh)),
            "pcn_qkv_ms": _event_ms(lambda: kenc.pcn_qkv(x, w)),
            "attn_mlp_residual_ms": _event_ms(
                lambda: kenc.attn_mlp_residual(kscale, qb, kb, vb, cache, kbias, h, w)),
        }
        if n <= kenc.MAX_FUSED_LAYER_N:
            res["fused_encoder_layer_ms"] = _event_ms(
                lambda: kenc.fused_encoder_layer(x, cache, kbias, w))
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
    with torch.no_grad():
        cases = [(pcn_qkv_case, n) for n in (12288, 20480)]
        cases += [(refine_case, n) for n in (5120, 12288, 20480)]
        cases += [(case, n) for case in (cache_case, nms_case) for n in (5120, 12288)]
        cases += [(scoring_case, 5120)]
        cases += [(confidence_case, n) for n in (5120, 12288, 20480)]
        cases += [(seed_stage_case, n) for n in (5120, 12288)]
        cases += [(train_attention_case, n) for n in TRAIN_SHAPES]
        cases += [(nn_search_case, n) for n in (2048, 5120, 20480)]
        cases += [(symcache_case, n) for n in SYM_SIZES]
        cases += [(symcache_weights_case, n) for n in SYM_WEIGHT_SIZES]
        for case, n in cases:
            if only and case.__name__ not in only:
                continue
            lines.append(json.dumps({"card": card, **case(n, dev)}))
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
