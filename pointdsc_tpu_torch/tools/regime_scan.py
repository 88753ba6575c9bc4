"""Offset-softmax bound slack of a snapshot over synthetic pairs, on a CUDA
card.

    python -m pointdsc_tpu_torch.tools.regime_scan --snapshot synthetic|kitti
        [--n N] [--pairs 32] [--seed 0] [--inlier_ratio 0.4] [--out FILE]

``synthetic``: snapshot/PointDSC_Synthetic_release on unit-scale pairs
(scene half-width 1.5, noise 0.005); ``kitti``:
snapshot/PointDSC_SyntheticKITTI_release on the pairs it was trained on
(half-width 50 m, noise 0.05 m, inlier radius 0.6 m). Prints one JSON object:
the slack of every pair in nats (models/regime.py::offset_regime_slack), and
the share of pairs at or above the 60-nat limit, where the Evaluator would
switch to the running-max kernel.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

import pointdsc_tpu_torch as pt
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.models.regime import OFFSET_REGIME_MAX_SLACK, offset_regime_slack
from pointdsc_tpu_torch.tools.profile_forward import ROOT, SNAPSHOTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snapshot", choices=sorted(SNAPSHOTS), default="synthetic")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inlier_ratio", type=float, default=0.4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("regime_scan: needs a CUDA card")
    name, n, ds_kw = SNAPSHOTS[args.snapshot]
    n = args.n or n
    model = pt.load_pretrained(os.path.join(ROOT, "snapshot", name), device="cuda")
    ds = SyntheticPairDataset(num_pairs=args.pairs, num_corr=n, seed=args.seed,
                              inlier_ratio=args.inlier_ratio, **ds_kw)
    slacks = []
    for i in range(args.pairs):
        ex = ds[i]
        tensors = [torch.as_tensor(ex[k])[None].cuda()
                   for k in ("corr_pos", "src_keypts", "tgt_keypts")]
        slacks.append(offset_regime_slack(model, *tensors))
    out_of_regime = sum(s >= OFFSET_REGIME_MAX_SLACK for s in slacks) / len(slacks)
    result = {"snapshot": name, "n": n, "seed": args.seed, "inlier_ratio": args.inlier_ratio,
              "dataset": ds_kw, "slack_nats": slacks, "limit_nats": OFFSET_REGIME_MAX_SLACK,
              "share_out_of_regime": out_of_regime}
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
