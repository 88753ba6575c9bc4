"""Kernel-only times of the attention loops, of the split PointCN + QKV
kernel, of the post-refinement, of the int8 cache build, of the seed NMS,
of the scoring kernel and of the confidence head, on a CUDA card.

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
of its three kernels in ``kernels_ms``). ``wrapper_ms``: CUDA events around one
wrapper call; ``kernel_ms``: the kernel's own device time per call from
``torch.profiler`` (``profile_forward``'s device summary over 20 calls; the
seed NMS's kernels each in ``kernels_ms``), beside all the call's device
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

from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import conf_mlp as kconf
from pointdsc_tpu_torch.kernels import encoder_layer as kenc
from pointdsc_tpu_torch.kernels import nms as knms
from pointdsc_tpu_torch.kernels import refine as kref
from pointdsc_tpu_torch.kernels import sc_attention as katt
from pointdsc_tpu_torch.kernels import scoring as kscore
from pointdsc_tpu_torch.tools.profile_forward import SNAPSHOTS, _device_profile

C = 128


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
            **_device_split(call, "compat_cache_kernel")}


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
