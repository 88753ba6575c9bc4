"""Where the time of one fused eval forward goes, on a CUDA card.

    python -m pointdsc_tpu_torch.tools.profile_forward
        [--config default|running_max|no_cache] [--snapshot synthetic|kitti] [--n N]
        [--out FILE]

Loads a snapshot (``synthetic``: PointDSC_Synthetic_release, N = 5120,
unit-scale pairs; ``kitti``: PointDSC_SyntheticKITTI_release, N = 12288, the
50 m pairs it was trained on) in one configuration (``default``: the offset
softmax's whole-layer kernels; ``running_max``: the per-op encoder around the
running-max attention kernel; ``no_cache``: ``fused_cache_compat=False``, the
per-op encoder around the attention that computes its compat tiles from the
geometry, no int8 cache), runs one synthetic pair (seed 0, inlier ratio
0.4) through ``register`` and reports, as one JSON object (printed, and
written to ``--out``):

* ``forward_ms``: host wall time of one forward ending in a synchronize
  (median of 10 after 2 warm-ups);
* ``stages_ms``: the same forward cut into its stages (cache build,
  encoder, seed NMS, seed transforms with scoring, post-refinement), each
  stage closed by a synchronize, median of 5; the rest of ``forward_ms``
  is the input copy, the confidence head and the glue between stages;
* ``device``: from ``torch.profiler`` over 3 forwards, per forward: the
  device operations (kernels, copies, sets) launched, their summed device
  time, the device busy share of the wall time, and the 12 operation names
  with the most device time. When the profiler sees no device activity,
  these read "not measured".
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from collections import defaultdict

import torch

import pointdsc_tpu_torch as pt
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.models import pointdsc as model_mod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# name -> (snapshot directory, its N, the synthetic data it was trained on)
SNAPSHOTS = {
    "synthetic": ("PointDSC_Synthetic_release", 5120, {}),
    "kitti": ("PointDSC_SyntheticKITTI_release", 12288,
              dict(scene_scale=50.0, noise=0.05, inlier_threshold=0.6)),
}


def _wall_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _stage_times(model, run, reps=5):
    """Wrap each stage so it ends in a synchronize and records its wall time."""
    record = defaultdict(list)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    patches = [
        (model_mod, "build_compat_cache_int8", "int8 cache build"),
        (model.encoder, "forward", "encoder (12 layers)"),
        (model_mod, "pick_seeds_nms_prefiltered", "seed NMS"),
        (model, "_seed_transforms", "seed kNN + NSM + Procrustes + scoring"),
        (model, "post_refinement", "post-refinement (20 rounds)"),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, name in patches:
            setattr(obj, attr, timed(name, getattr(obj, attr)))
        run()
        record.clear()
        for _ in range(reps):
            run()
    finally:
        for obj, attr, fn in saved:
            if obj is model or obj is model.encoder:
                delattr(obj, attr)  # drop the instance attribute, back to the method
            else:
                setattr(obj, attr, fn)
    return {name: statistics.median(v) for name, v in record.items()}


def _device_profile(run, forwards=3):
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name = defaultdict(lambda: [0, 0.0])
    launches_cpu = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us()
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches_cpu += 1
    if not per_name:
        return {"device_ops_per_forward": "not measured",
                "kernel_launch_calls_per_forward": launches_cpu / forwards,
                "device_ms_per_forward": "not measured", "busy_share": "not measured"}
    ops = sum(c for c, _ in per_name.values())
    dev_us = sum(t for _, t in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "device_ops_per_forward": ops / forwards,
        "kernel_launch_calls_per_forward": launches_cpu / forwards,
        "device_ms_per_forward": dev_us / forwards / 1e3,
        "wall_ms_per_forward": wall_us / forwards / 1e3,
        "busy_share": dev_us / wall_us,
        "top_ops": [{"name": n[:80], "count_per_forward": c / forwards,
                     "ms_per_forward": t / forwards / 1e3} for n, (c, t) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("default", "running_max", "no_cache"),
                    default="default")
    ap.add_argument("--snapshot", choices=sorted(SNAPSHOTS), default="synthetic")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA card")
    name, n, ds_kw = SNAPSHOTS[args.snapshot]
    n = args.n or n
    model = pt.load_pretrained(os.path.join(ROOT, "snapshot", name), device="cuda",
                               offset_softmax=args.config != "running_max",
                               fused_cache_compat=args.config != "no_cache")
    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.4, seed=0, **ds_kw)[0]

    def run():
        return pt.register(ex["corr_pos"], ex["src_keypts"], ex["tgt_keypts"], model=model,
                           device="cuda")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {
        "card": card, "n": n, "config": args.config, "snapshot": name,
        "forward_ms": _wall_ms(run, reps=10),
        "stages_ms": _stage_times(model, run),
        "device": _device_profile(run),
    }
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
