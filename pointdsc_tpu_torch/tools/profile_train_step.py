"""Where the time of one train step goes, on a CUDA card.

    python -m pointdsc_tpu_torch.tools.profile_train_step [--config fused|dense]
        [--kitti_regime] [--out FILE]

Builds the Trainer at the reference training shape (12 layers, C = 128,
k = 40, bs 16, 1000 correspondences padded to 1024, Adam; ``--kitti_regime``:
N = 12288, bs 2, sigma_d 1.2, 50 m scenes) with random weights of seed 0,
runs ``train_step`` on one synthetic batch and reports, as one JSON object
(printed, and written to ``--out``):

* ``step_ms``: host wall time of one step ending in a synchronize (median of
  10 after 3 warm-ups), and ``peak_memory_gib``;
* ``stages_ms``: the same step cut into stages, each closed by a synchronize,
  median of 5: the forward with its losses (of which the encoder and the seed
  stage are also given alone), the backward pass, the optimizer step; the
  rest of the step is ``zero_grad``, the finite-gradient check with its host
  read, and the metrics;
* ``device``: from ``torch.profiler`` over 3 steps, per step: the device
  operations launched, their summed device time, the device busy share of
  the wall time, and the 12 operation names with the most device time.
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

from pointdsc_tpu_torch.data import SyntheticPairDataset, collate_batch
from pointdsc_tpu_torch.tools.profile_forward import _device_profile, _wall_ms
from pointdsc_tpu_torch.train.config import default_config
from pointdsc_tpu_torch.train.trainer import Trainer


def _stage_times(trainer, state, run, reps=5):
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

    model = state.model
    patches = [
        (trainer, "_losses", "forward + losses"),
        (model.encoder, "forward", "  of which encoder forward (12 layers)"),
        (model, "_seed_transforms", "  of which seed kNN + NSM + Procrustes + scoring"),
        (torch.Tensor, "backward", "backward"),
        (state.optimizer, "step", "optimizer step"),
    ]
    saved = [(obj, attr, getattr(obj, attr), attr in vars(obj)) for obj, attr, _ in patches]
    try:
        for obj, attr, name in patches:
            setattr(obj, attr, timed(name, getattr(obj, attr)))
        run()
        record.clear()
        for _ in range(reps):
            run()
    finally:
        for obj, attr, fn, own in saved:
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)  # drop the instance attribute, back to the method
    return {name: statistics.median(v) for name, v in record.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("fused", "dense"), default="fused")
    ap.add_argument("--kitti_regime", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: needs a CUDA card")

    cfg = default_config("KITTI" if args.kitti_regime else "3DMatch")
    ds_kw = {}
    if args.kitti_regime:
        cfg.num_node, cfg.batch_size, cfg.inlier_threshold, cfg.sigma_d = 12288, 2, 0.6, 1.2
        ds_kw = dict(scene_scale=50.0, noise=0.05, inlier_threshold=cfg.inlier_threshold)
    cfg.fused_attention = cfg.fused_sm_loss = args.config == "fused"
    cfg.tboard_dir, cfg.verbose = "", False
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=100, seed=0)
    ds = SyntheticPairDataset(num_pairs=cfg.batch_size, num_corr=cfg.num_node, inlier_ratio=0.35,
                              seed=3, **ds_kw)
    batch = trainer.to_device(collate_batch([ds[i] for i in range(cfg.batch_size)]))

    def run():
        return trainer.train_step(state, batch, 1)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.reset_peak_memory_stats()
    result = {
        "card": card, "config": args.config, "bs": cfg.batch_size,
        "n": batch["corr_pos"].shape[1],
        "step_ms": _wall_ms(run, reps=10, warmup=3),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "stages_ms": _stage_times(trainer, state, run),
        # profile_forward's keys say "forward" for what is a step here
        "device": json.loads(json.dumps(_device_profile(run)).replace("_per_forward", "_per_step")),
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
