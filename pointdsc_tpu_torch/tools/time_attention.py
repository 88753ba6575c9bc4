"""Kernel-only times of the attention loops, on a CUDA card.

    python -m pointdsc_tpu_torch.tools.time_attention [--out FILE]

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
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import torch

from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import encoder_layer as kenc
from pointdsc_tpu_torch.kernels import sc_attention as katt
from pointdsc_tpu_torch.tools.profile_forward import SNAPSHOTS

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


def _inputs(n, sigma_d, ds_kw, dev):
    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.4, seed=1, **ds_kw)[0]
    src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
    tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
    mask = (torch.arange(n) < n - n // 20)[None].to(dev)
    gen = torch.Generator().manual_seed(0)
    shapes = ((C, C), (C,), (C, 3 * C), (3 * C,), (C, C // 2), (C // 2,), (C // 2, C // 2),
              (C // 2,), (C // 2, C), (C,))
    weights = tuple((torch.randn(s, generator=gen) * C ** -0.5).to(dev) for s in shapes)
    x = torch.randn((1, n, C), generator=gen).to(dev)
    qkv = [torch.randn((1, n, C), generator=gen).to(dev) for _ in range(3)]
    cache = katt.build_compat_cache_int8(src, tgt, sigma_d, mask=mask)
    return (x, weights, qkv, cache, katt.key_bias(mask, 1, n, dev),
            katt.pack_geometry(src, tgt, mask))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = []
    for name, sigma_d in (("synthetic", 0.1), ("kitti", 1.2)):
        _, n, ds_kw = SNAPSHOTS[name]
        x, w, (q, k, v), cache, kbias, geom = _inputs(n, sigma_d, ds_kw, dev)
        qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
        h, qb, kb, vb, kscale = kenc.pcn_qkv(x, w)
        res = {
            "card": card, "n": n,
            "running_max_ms": _event_ms(
                lambda: katt._launch_sc_attention(qh, kh, vh, cache, kbias)),
            "nocache_ms": _event_ms(
                lambda: katt._launch_sc_attention_nocache(qh, kh, vh, geom, sigma_d)),
            "offset_ms": _event_ms(
                lambda: katt._launch_sc_attention_offset(qh, kh, vh, cache, kbias)),
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
