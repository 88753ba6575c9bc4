"""Experiment: the symmetric int8 compat-cache build (upper triangle + mirror)
against the full-grid build, on a CUDA card (the port's counterpart of the
JAX package's ``tools/exp_symcache.py``).

    PROFILE_N=20480 SYM_BLOCK=256 PROFILE_ITERS=16 \\
        python -m pointdsc_tpu_torch.tools.exp_symcache

Builds one synthetic pair's cache both ways through the public wrappers
(kernels/symcache.py, kernels/sc_attention.py), checks that the bytes are
equal, and times the full-grid build, the upper tiles alone and the upper
tiles + mirror (CUDA events per call, median of PROFILE_ITERS after 3
warm-ups; the geometry packing, the same in all three, included). Prints one
JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess

import torch

from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels.sc_attention import build_compat_cache_int8
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
    blk = int(os.environ.get("SYM_BLOCK", 256))
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

    full = build_compat_cache_int8(src, tgt, 0.1)
    sym = build_compat_cache_int8_sym(src, tgt, 0.1, block=blk)
    torch.cuda.synchronize()
    equal = torch.equal(full, sym)
    del full, sym
    nb = n // blk
    res = {
        "experiment": "symmetric_cache", "card": card, "n": n, "block": blk,
        "tiles_upper": nb * (nb + 1) // 2, "tiles_mirrored": nb * (nb - 1) // 2,
        "tiles_full_grid_equivalent": nb * nb, "bitwise_equal": equal,
        "full_grid_ms": _event_ms(lambda: build_compat_cache_int8(src, tgt, 0.1), iters),
        "upper_tiles_ms": _event_ms(
            lambda: build_compat_cache_int8_sym(src, tgt, 0.1, block=blk, mirror=False), iters),
        "upper_tiles_and_mirror_ms": _event_ms(
            lambda: build_compat_cache_int8_sym(src, tgt, 0.1, block=blk), iters),
    }
    print(json.dumps(res), flush=True)
    if not equal:
        raise SystemExit("exp_symcache: the symmetric build differs from the full-grid one")
    return res


if __name__ == "__main__":
    main()
