"""Registration of a pair of .ply clouds end to end (the port's counterpart of
the JAX package's ``demo_registration.py``).

PLY load -> FPFH (descriptors/fpfh.py) -> descriptor NN matching
(data/pipeline.py::build_correspondences) -> PointDSC through ``register``
(the fused path and its kernels, behind the Evaluator's regime probe) -> optional point-to-point ICP on the
whole downsampled clouds (ops/icp.py, the nearest-neighbour kernel) ->
``src_warped.ply``, ``tgt.ply`` and ``pred_trans.npy`` in ``--out_dir``.

    python -m pointdsc_tpu_torch.tools.demo_registration \\
        --src_path cloud_bin_0.ply --tgt_path cloud_bin_1.ply \\
        [--chosen_snapshot PointDSC_Synthetic_release] [--use_icp true] [--device cpu]

``--chosen_snapshot`` names a directory under ``snapshot/`` (relative to the
working directory); without one, or without its checkpoint, the model runs
with random weights drawn from a seeded generator: the spatial-consistency
stages (NSM, Procrustes, refinement) do not depend on learned features and
still give a usable transform. The JAX demo runs the dense forward; this one
runs the fused forward, which agrees with it within 1e-3.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def str2bool(v):
    return str(v).lower() in ("true", "1")


def main(argv=None, report: dict | None = None):
    """Run the demo; returns the [4, 4] transform. ``report``, when given, is
    filled with the stage times in seconds (``stages_s``), the keypoint
    counts, the sampled correspondences, the regime probe's slack and
    verdict, and the ICP fitness and rmse."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chosen_snapshot", default="", type=str)
    parser.add_argument("--src_path", default="demo_data/cloud_bin_0.ply", type=str)
    parser.add_argument("--tgt_path", default="demo_data/cloud_bin_1.ply", type=str)
    parser.add_argument("--descriptor", default="fpfh", choices=["fpfh"])
    parser.add_argument("--voxel_size", default=0.03, type=float)
    parser.add_argument("--use_icp", default=False, type=str2bool)
    parser.add_argument("--out_dir", default="demo_out", type=str)
    parser.add_argument("--num_node", default=2048, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    import torch

    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.api import load_pretrained, register
    from pointdsc_tpu_torch.data import transforms_np as T
    from pointdsc_tpu_torch.data.pipeline import build_correspondences, pad_to_bucket
    from pointdsc_tpu_torch.data.ply import read_ply_xyz, write_ply_xyz
    from pointdsc_tpu_torch.descriptors import extract_fpfh
    from pointdsc_tpu_torch.models import PointDSC
    from pointdsc_tpu_torch.models.regime import select_attention_kernels
    from pointdsc_tpu_torch.ops.icp import icp_point_to_point
    from pointdsc_tpu_torch.train.config import Config, default_config

    dev = resolve_device(args.device)
    report = {} if report is None else report
    stages = report.setdefault("stages_s", {})
    clock = [time.perf_counter()]

    def lap(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stages[name] = now - clock[0]
        clock[0] = now

    snap_dir = os.path.join("snapshot", args.chosen_snapshot)
    if args.chosen_snapshot:
        cfg = Config.load(os.path.join(snap_dir, "config.json"))
    else:
        cfg = default_config("3DMatch")
        cfg.descriptor = "fpfh"

    print(f"Loading clouds:\n  src: {args.src_path}\n  tgt: {args.tgt_path}")
    src_raw = read_ply_xyz(args.src_path)
    tgt_raw = read_ply_xyz(args.tgt_path)
    lap("load")

    print(f"Extracting FPFH descriptors ({dev.type})...")
    src_pts, src_feat = extract_fpfh(src_raw, voxel_size=args.voxel_size, device=dev)
    tgt_pts, tgt_feat = extract_fpfh(tgt_raw, voxel_size=args.voxel_size, device=dev)
    src_feat = src_feat / (np.linalg.norm(src_feat, axis=1, keepdims=True) + 1e-6)
    tgt_feat = tgt_feat / (np.linalg.norm(tgt_feat, axis=1, keepdims=True) + 1e-6)
    print(f"  {len(src_pts)} / {len(tgt_pts)} keypoints")
    report["keypoints"] = (len(src_pts), len(tgt_pts))
    lap("fpfh")

    sample = build_correspondences(
        src_pts, tgt_pts, src_feat, tgt_feat, np.eye(4), cfg.inlier_threshold,
        num_node=args.num_node, use_mutual=False, in_dim=cfg.in_dim,
        rng=np.random.default_rng(cfg.seed), device=dev.type)
    report["sample"] = sample
    lap("matching")

    ckpt = os.path.join(snap_dir, "models", "model_best.pkl")
    if args.chosen_snapshot and os.path.exists(ckpt):
        model = load_pretrained(snap_dir, device=dev)
        print(f"Loaded weights from {ckpt}")
    else:
        model = PointDSC(in_dim=cfg.in_dim, num_layers=cfg.num_layers,
                         num_channels=cfg.num_channels, num_iterations=cfg.num_iterations,
                         ratio=cfg.ratio, sigma_d=cfg.sigma_d, k=cfg.k,
                         inlier_threshold=cfg.inlier_threshold, device=dev,
                         generator=torch.Generator().manual_seed(0))
        print("No snapshot weights; running with random-init encoder")
    model.nms_radius = cfg.inlier_threshold  # as the JAX demo builds its model
    lap("model")

    print("Running PointDSC...")
    padded = pad_to_bucket(sample)
    inputs = [torch.as_tensor(padded[k])[None].to(dev)
              for k in ("corr_pos", "src_keypts", "tgt_keypts", "mask")]
    # the offset softmax holds only inside its regime, which depends on the
    # pair: FPFH correspondences can leave it (the JAX demo runs the dense
    # forward, which has no regime), so the pair is probed first, as the
    # Evaluator probes, and an out-of-regime pair runs the running-max kernel
    model, report["slack"], report["flipped"] = select_attention_kernels(
        model, *inputs[:3], mask=inputs[3], context="demo")
    out = register(*inputs, model=model, device=dev)
    trans = out.final_trans[0].cpu().numpy()
    n_inlier = int(out.final_labels.sum())
    print(f"Predicted transform ({n_inlier} inliers):\n{trans}")
    lap("forward")

    if args.use_icp:
        trans_t, fitness, rmse = icp_point_to_point(
            torch.as_tensor(src_pts, device=dev), torch.as_tensor(tgt_pts, device=dev),
            torch.as_tensor(trans, device=dev), max_correspondence_distance=cfg.inlier_threshold)
        trans = trans_t.cpu().numpy()
        report["icp"] = (float(fitness), float(rmse))
        print(f"After ICP (fitness {float(fitness):.3f}, rmse {float(rmse):.4f}):\n{trans}")
        lap("icp")

    os.makedirs(args.out_dir, exist_ok=True)
    write_ply_xyz(os.path.join(args.out_dir, "src_warped.ply"), T.transform(src_raw, trans))
    write_ply_xyz(os.path.join(args.out_dir, "tgt.ply"), tgt_raw)
    np.save(os.path.join(args.out_dir, "pred_trans.npy"), trans)
    print(f"Wrote {args.out_dir}/src_warped.ply, tgt.ply, pred_trans.npy")
    print("stage seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    return trans


if __name__ == "__main__":
    main()
