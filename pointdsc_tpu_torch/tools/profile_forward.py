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
* ``stages_ms``: device time by program stage, from one profiled forward
  with no synchronize between stages: each device operation is put down to
  the innermost ``pointdsc.*`` span (utils/trace.py) open when the host
  launched it (``span_times``); ``outside`` is what launched outside every
  span (``register``'s input copies);
* ``first_call_ms``: the host time of the process's first forward, which
  builds and loads the kernel libraries, by its ``pointdsc.kernels.build``
  and ``pointdsc.kernels.load`` spans, with the counters ``kernel_builds``
  (nvcc runs) and ``kernel_loads`` (libraries loaded) of ``kernels/_build.py``;
* ``device``: from ``torch.profiler`` over 3 forwards, per forward: the
  device operations (kernels, copies, sets) launched, their summed device
  time, the device busy share of the wall time, and the 12 operation names
  with the most device time. When the profiler sees no device activity,
  these read "not measured".
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import time
from collections import defaultdict

import torch

import pointdsc_tpu_torch as pt
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import _build

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


# CPU events of the CUDA runtime and driver: a device operation carries the
# correlation id of the call that launched it. Releases of torch whose events
# have no ``activity_type`` (2.11) are told by the calls' names.
_RUNTIME = ("cuda_runtime", "cuda_driver")


def _is_runtime(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in _RUNTIME
    return e.name.startswith("cu")


def span_times(events, prefix: str = "pointdsc.", window=None) -> dict:
    """Device and idle time of a ``torch.profiler`` session by program span.

    ``events``: the profiler's ``events()``; spans are the CPU events whose
    name starts with ``prefix``. A device operation (a kernel, copy or set;
    a span's mirror on the device timeline is none) belongs to the innermost
    span open when the host launched it: the CUDA runtime or driver call of
    the same correlation id, else the host operation it links to by
    ``linked_correlation_id`` (where the torch release records it). An idle gap of the device belongs to the
    innermost span open at its middle. Spans are walked as intervals, with
    no limit on how many host events lie between a gap and its span.
    ``window`` (start, end) in the profiler's microseconds bounds the device
    timeline; by default it runs from the first span's start to the last
    span's or device operation's end.

    Returns seconds: {"spans": {name: {"n", "host_s", "self_s" (host_s less
    the child spans'), "device_s", "idle_s"}}, "device_s", "busy_s",
    "window_s", "outside_device_s", "outside_idle_s"}.
    """
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    names = {e.name for e in host}
    device = [e for e in events if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False) and e.name not in names]
    spans = sorted((e for e in host if e.name.startswith(prefix)),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    out = {"spans": {}, "device_s": 0.0, "busy_s": 0.0, "window_s": 0.0,
           "outside_device_s": 0.0, "outside_idle_s": 0.0}
    if not spans:
        return out
    stats = out["spans"]
    for e in spans:
        st = stats.setdefault(e.name, {"n": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
                                       "idle_s": 0.0})
        st["n"] += 1
        st["host_s"] += e.time_range.elapsed_us() * 1e-6
        st["self_s"] += e.time_range.elapsed_us() * 1e-6

    # the innermost open span as disjoint segments [start, end, name]: a
    # sweep over the spans in start order, each clipped to its parent
    segs, stack, cursor = [], [], float("-inf")

    def advance(t):
        nonlocal cursor
        if stack and t > cursor:
            segs.append((cursor, t, stack[-1][0]))
        cursor = max(cursor, t)

    for e in spans:
        start, end = e.time_range.start, e.time_range.end
        while stack and stack[-1][1] <= start:
            advance(stack[-1][1])
            stack.pop()
        advance(start)
        if stack:
            end = min(end, stack[-1][1])
            stats[stack[-1][0]]["self_s"] -= (end - start) * 1e-6
        stack.append((e.name, end))
    while stack:
        advance(stack[-1][1])
        stack.pop()
    seg_starts = [seg[0] for seg in segs]

    def innermost(t):
        i = bisect.bisect_right(seg_starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else None

    launched = {e.id: e.time_range.start for e in host if e.id and _is_runtime(e)}
    ops = {e.id: e.time_range.start for e in host if e.id and not _is_runtime(e)}
    lo, hi = window or (spans[0].time_range.start,
                        max(e.time_range.end for e in (*spans, *device)))
    busy = []
    for e in device:
        start, end = e.time_range.start, e.time_range.end
        if end <= lo or start >= hi:
            continue
        t = launched.get(e.id, ops.get(getattr(e, "linked_correlation_id", 0) or None))
        name = None if t is None else innermost(t)
        dt = (end - start) * 1e-6
        out["device_s"] += dt
        if name is None:
            out["outside_device_s"] += dt
        else:
            stats[name]["device_s"] += dt
        busy.append((max(start, lo), min(end, hi)))
    busy.sort()
    edge = lo
    for start, end in busy + [(hi, hi)]:
        if start > edge:
            name = innermost((start + edge) / 2)
            if name is None:
                out["outside_idle_s"] += (start - edge) * 1e-6
            else:
                stats[name]["idle_s"] += (start - edge) * 1e-6
        out["busy_s"] += max(0.0, end - max(start, edge)) * 1e-6
        edge = max(edge, end)
    out["window_s"] = (hi - lo) * 1e-6
    return out


def _stage_times(run) -> dict | str:
    """Device ms of one profiled forward by its innermost stage span."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    times = span_times(prof.events())
    if times["device_s"] <= 0:
        return "not measured"
    stages = {name: st["device_s"] * 1e3 for name, st in times["spans"].items()}
    stages["outside"] = times["outside_device_s"] * 1e3
    return stages


def _first_call(run) -> dict:
    """Host ms of the first forward and of its kernel build and load spans."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    spans = span_times(prof.events(), prefix="pointdsc.kernels.")["spans"]
    return {"total": (time.perf_counter() - t0) * 1e3,
            **{name: st["host_s"] * 1e3 for name, st in spans.items()}}


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
    events = prof.events()
    host = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in host:
                continue  # a span's mirror on the device timeline
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

    first_call_ms = _first_call(run)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {
        "card": card, "n": n, "config": args.config, "snapshot": name,
        "first_call_ms": first_call_ms,
        "kernel_builds": _build.builds, "kernel_loads": _build.loads,
        "forward_ms": _wall_ms(run, reps=10),
        "stages_ms": _stage_times(run),
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
