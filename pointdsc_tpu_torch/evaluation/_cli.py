"""What the three benchmark CLIs share: their common flags, the model of a
snapshot, the Evaluator and the report with its log and ``.npy`` files.

A snapshot is ``snapshot/<id>/config.json`` and
``snapshot/<id>/models/model_best.pkl``, relative to the working directory,
as the JAX package's CLIs read it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def str2bool(v):
    return str(v).lower() in ("true", "1")


def parser(description: str, solver: bool = True) -> argparse.ArgumentParser:
    """The flags of every CLI; ``solver`` adds ``--solver`` and ``--use_icp``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--chosen_snapshot", default="", type=str)
    if solver:
        p.add_argument("--solver", default="SVD", type=str, choices=["SVD", "RANSAC"],
                       help="SVD: the model's transform; RANSAC: re-solved by the RANSAC "
                            "baseline on the model's inliers (4096 hypotheses)")
        p.add_argument("--use_icp", default=False, type=str2bool)
    p.add_argument("--save_npy", default=False, type=str2bool)
    p.add_argument("--fused_attention", default="auto", choices=["auto", "true", "false"],
                   help="the fused CUDA kernels (auto: on when the device is CUDA)")
    p.add_argument("--root", default="", type=str, help="override the data root")
    p.add_argument("--sharded", default=False, type=str2bool,
                   help="fan pairs across every visible card, one pair a card at a time "
                        "(with --device cpu: a mesh of the one CPU device)")
    p.add_argument("--sp", default=False, type=str2bool,
                   help="sequence-parallel eval: every pair's encoder row-sharded over every "
                        "visible card (with --device cpu: a mesh of the one CPU device); "
                        "mutually exclusive with --sharded")
    p.add_argument("--device", default="cuda", type=str)
    return p


def parse(p: argparse.ArgumentParser, argv):
    args = p.parse_args(argv)
    if args.sp and args.sharded:
        p.error("--sp and --sharded are mutually exclusive")
    return args


def load_config(args):
    """The snapshot's Config with ``--root`` applied, and the seed set."""
    from pointdsc_tpu_torch.train.config import Config
    from pointdsc_tpu_torch.utils.seed import set_seed

    cfg = Config.load(f"snapshot/{args.chosen_snapshot}/config.json")
    if args.root:
        cfg.root = args.root
    set_seed(cfg.seed)
    return cfg


def make_evaluator(args, cfg, use_icp: bool = False, solver: str = "SVD"):
    """PointDSC of the config on ``--device`` (the reference passes the inlier
    threshold as the NMS radius) with the snapshot's best weights, inside the
    Evaluator. ``--sp`` hands the Evaluator a mesh of every visible card (on
    the CPU, of the CPU device)."""
    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.eval.runner import Evaluator
    from pointdsc_tpu_torch.models import PointDSC
    from pointdsc_tpu_torch.parallel.mesh import make_mesh
    from pointdsc_tpu_torch.train.trainer import load_model_weights

    dev = resolve_device(args.device)
    model = PointDSC(in_dim=cfg.in_dim, num_layers=cfg.num_layers,
                     num_channels=cfg.num_channels, num_iterations=cfg.num_iterations,
                     ratio=cfg.ratio, sigma_d=cfg.sigma_d, k=cfg.k,
                     inlier_threshold=cfg.inlier_threshold, nms_radius=cfg.inlier_threshold,
                     device=dev)
    load_model_weights(model, f"snapshot/{args.chosen_snapshot}/models/model_best.pkl")
    fused = args.fused_attention == "true" or (args.fused_attention == "auto"
                                               and dev.type == "cuda")
    sp_mesh = None
    if args.sp:
        sp_mesh = make_mesh() if dev.type == "cuda" else [dev]
    return Evaluator(model, re_thre=cfg.re_thre, te_thre=cfg.te_thre, use_icp=use_icp,
                     icp_threshold=cfg.inlier_threshold, solver=solver,
                     fused_attention=fused, sp_mesh=sp_mesh, device=dev)


def evaluate(args, evaluator, dataset, log_path: str, scene_of=None):
    """Run every pair, print the report under a header line that names the
    kernels' configuration (the regime guard's flip and its last slack),
    append it to ``log_path`` and save the stats beside it with
    ``--save_npy``. Returns ([pairs, 12] stats, aggregate dict)."""
    from pointdsc_tpu_torch.eval.protocol import format_scene_report

    if args.sharded:  # every visible card, or the CPU device
        stats, agg = evaluator.run_dataset_sharded(dataset, scene_of=scene_of)
    else:
        stats, agg = evaluator.run_dataset(dataset, scene_of=scene_of)
    slack = evaluator.last_slack
    header = (f"{args.chosen_snapshot} on {evaluator.device}: fused_attention="
              f"{evaluator._fused_attention}, guard flipped={evaluator.flipped}, last slack="
              + ("n/a" if slack is None else f"{slack:.3f} nats"))
    report = header + "\n" + format_scene_report(agg)
    print(report)

    os.makedirs("logs", exist_ok=True)
    with open(log_path, "a") as f:
        f.write(report + "\n")
    if args.save_npy:
        np.save(log_path.replace(".log", ".npy"), stats)
        print(f"Save the stats in {log_path.replace('.log', '.npy')}")
    return stats, agg
