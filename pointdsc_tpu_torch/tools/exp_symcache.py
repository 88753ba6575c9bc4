"""Experiment: the symmetric int8 compat-cache build (each unordered pair
once, the mirror written from the computation) against the full-grid build,
on a CUDA card (the port's counterpart of the JAX package's
``tools/exp_symcache.py``).

    PROFILE_N=20480 PROFILE_ITERS=16 python -m pointdsc_tpu_torch.tools.exp_symcache

Builds one synthetic pair's cache both ways, through the symmetric wrapper
(kernels/symcache.py) and the full-grid kernel's launch
(kernels/sc_attention.py, whichever route the production wrapper takes at
this N), checks that the bytes are equal, and times both builds (CUDA
events per call, median of PROFILE_ITERS after 3 warm-ups). Prints one JSON
object with the card's name and power limit and the route the production
wrapper takes.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess

import torch

from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import sc_attention as katt
from pointdsc_tpu_torch.kernels.symcache import build_compat_cache_int8_sym


def _event_ms(fn, reps, warmup=3):
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


def main(argv=None) -> dict:
    n = int(os.environ.get("PROFILE_N", 20480))
    iters = int(os.environ.get("PROFILE_ITERS", 16))
    if not torch.cuda.is_available():
        raise SystemExit("exp_symcache: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.3, seed=7)[0]
    src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
    tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
    coef = katt.cache_coef(0.1)

    def full_grid():
        return katt._launch_compat_cache(src, tgt, coef)

    full = full_grid()
    sym = build_compat_cache_int8_sym(src, tgt, 0.1)
    torch.cuda.synchronize()
    equal = torch.equal(full, sym)
    del full, sym
    res = {
        "experiment": "symmetric_cache", "card": card, "n": n, "bitwise_equal": equal,
        "production_route": "symmetric" if katt.use_symmetric_cache(n) else "full_grid",
        "full_grid_ms": _event_ms(full_grid, iters),
        "symmetric_ms": _event_ms(lambda: build_compat_cache_int8_sym(src, tgt, 0.1), iters),
    }
    print(json.dumps(res), flush=True)
    if not equal:
        raise SystemExit("exp_symcache: the symmetric build differs from the full-grid one")
    return res


if __name__ == "__main__":
    main()
