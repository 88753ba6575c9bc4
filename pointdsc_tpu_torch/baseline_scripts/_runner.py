"""The evaluation loop both baseline CLIs share (the port's counterpart of
the JAX package's ``baseline_scripts/_runner.py``): the method dispatch over
SM / RANSAC / GCRANSAC / LS / PMC, the per-pair timing, the 12-column stats
row and the scene report. The CLIs differ only in dataset, thresholds and
the SM top ratio.
"""

from __future__ import annotations

import os

import numpy as np
import torch

METHODS = ["SM", "RANSAC", "GCRANSAC", "LS", "PMC"]


def str2bool(v) -> bool:
    return str(v).lower() in ("true", "1")


def add_common_flags(parser, method: str, root: str, num_node: int, inlier_threshold: float,
                     re_thre: float, te_thre: float) -> None:
    """The flags of both CLIs, with each CLI's defaults."""
    parser.add_argument("--method", default=method, choices=METHODS)
    parser.add_argument("--root", default=root, type=str)
    parser.add_argument("--descriptor", default="fcgf", choices=["fcgf", "fpfh"])
    parser.add_argument("--num_node", default=num_node, type=int)
    parser.add_argument("--inlier_threshold", default=inlier_threshold, type=float)
    parser.add_argument("--max_iteration", default=4096, type=int,
                        help="RANSAC / GCRANSAC hypotheses")
    parser.add_argument("--gc_minimizer", default="icm", choices=["icm", "exact"],
                        help="GCRANSAC labelling: ICM sweeps on the device or the exact native "
                             "s-t mincut on the host (native/maxflow.cpp)")
    parser.add_argument("--re_thre", default=re_thre, type=float)
    parser.add_argument("--te_thre", default=te_thre, type=float)
    parser.add_argument("--save_npy", default=False, type=str2bool)
    parser.add_argument("--device", default="cuda", type=str,
                        help="where the methods run (cuda raises without a card)")


def run_baseline(dataset, scene_list, scene_of, args, device, sm_top_ratio=0.1, save_tag=""):
    """Evaluate ``args.method`` over ``dataset`` on ``device``; returns
    ([pairs, 12] stats, aggregate dict). ``scene_list`` names the scenes of
    the report and ``scene_of(i)`` gives pair i's scene. RANSAC and GCRANSAC
    draw from one CPU generator seeded 0, advanced pair by pair. Each pair's
    model time ends in a device synchronise."""
    from pointdsc_tpu_torch.baselines import (
        gc_ransac_registration,
        least_squares_fit,
        pmc_registration,
        ransac_registration,
        spectral_matching,
    )
    from pointdsc_tpu_torch.eval.protocol import aggregate_stats, format_scene_report, pair_stats
    from pointdsc_tpu_torch.utils.timer import Timer

    rows = []
    timer = Timer()
    generator = torch.Generator().manual_seed(0)
    for i in range(len(dataset)):
        sample = dataset[i]
        src, tgt = (torch.as_tensor(sample[k], dtype=torch.float32)[None].to(device)
                    for k in ("src_keypts", "tgt_keypts"))
        timer.tic()
        if args.method == "SM":
            trans, labels = spectral_matching(src, tgt, args.inlier_threshold,
                                              top_ratio=sm_top_ratio)
        elif args.method == "RANSAC":
            trans, labels = ransac_registration(src, tgt, generator, args.inlier_threshold,
                                                num_hypotheses=args.max_iteration)
        elif args.method == "GCRANSAC":
            trans, labels = gc_ransac_registration(src, tgt, generator, args.inlier_threshold,
                                                   num_hypotheses=args.max_iteration,
                                                   minimizer=args.gc_minimizer)
        elif args.method == "LS":
            trans, labels = least_squares_fit(src, tgt,
                                              torch.as_tensor(sample["gt_labels"])[None].to(device))
        else:  # PMC
            trans_np, labels_np = pmc_registration(sample["src_keypts"], sample["tgt_keypts"],
                                                   args.inlier_threshold, device=device)
            trans, labels = torch.as_tensor(trans_np)[None], torch.as_tensor(labels_np)[None]
        model_time = timer.toc(average=False, block_on=trans)

        rows.append(pair_stats(trans[0].cpu().numpy(), labels[0].cpu().numpy(),
                               sample["gt_trans"], sample["gt_labels"], args.re_thre,
                               args.te_thre, model_time, 0.0, scene_of(i)))
        if (i + 1) % 100 == 0:
            print(f"[{i + 1}/{len(dataset)}]")

    stats = np.stack(rows)
    agg = aggregate_stats(stats, scene_list)
    print(format_scene_report(agg))
    if args.save_npy:
        os.makedirs("logs", exist_ok=True)
        np.save(f"logs/baseline{save_tag}-{args.method}-{args.descriptor}.npy", stats)
    return stats, agg
