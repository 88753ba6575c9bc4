"""Multiway registration on Augmented ICL-NUIM with ATE evaluation (the port's
counterpart of the JAX package's ``multiway/test_multi_ate.py``; the
reference's multiway/test_multi_ate.py).

    python -m pointdsc_tpu_torch.multiway.test_multi_ate --chosen_snapshot <id> \\
        --root R [--use_icp true] [--save_traj true] [--device cpu]

Per scene every fragment pair is registered by PointDSC (odometry pairs
then by multi-scale ICP from that estimate, loop closures pruned by
overlap), the pose graph is assembled and robustly optimized, optionally
ICP-refined and re-optimized, and scored as the ATE RMSE (cm) against the
ground-truth fragment trajectory. ``--fused auto`` runs the fused CUDA
kernels when the device is CUDA; then the offset softmax's regime is probed
on the first 3 pairs (models/regime.py), and a pair outside it switches the
model to the running-max kernel.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pointdsc_tpu_torch.evaluation._cli import str2bool
from pointdsc_tpu_torch.multiway import _cli


def register_pairs(model, dataset, fused: bool, device):
    """PointDSC's transform of every pair of the dataset: ({(i, j): [4, 4]},
    the model the guard left). Pairs are padded to their bucket."""
    from pointdsc_tpu_torch.data.pipeline import pad_to_bucket
    from pointdsc_tpu_torch.models.regime import select_attention_kernels

    pairwise = {}
    probes_left = 3 if fused else 0
    for idx in range(len(dataset)):
        i, j = dataset.pair_ids(idx)
        padded = pad_to_bucket(dataset[idx])
        corr_pos, src, tgt = (torch.as_tensor(padded[k])[None].to(device, torch.float32)
                              for k in ("corr_pos", "src_keypts", "tgt_keypts"))
        mask = torch.as_tensor(padded["mask"])[None].to(device)
        if probes_left > 0:
            # the offset-softmax kernels are exact only inside a validity
            # regime that imported weights or out-of-distribution fragments
            # can leave; the slack depends on the pair
            probes_left -= 1
            model, _, flipped = select_attention_kernels(model, corr_pos, src, tgt, mask=mask,
                                                         context="multiway")
            if flipped:
                probes_left = 0
        with torch.no_grad():
            out = model(corr_pos, src, tgt, mask=mask, testing=True, fused=fused)
        pairwise[(i, j)] = out.final_trans[0].cpu().numpy()
    return pairwise, model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chosen_snapshot", default="", type=str)
    parser.add_argument("--root", default="/data/Augmented_ICL-NUIM", type=str)
    parser.add_argument("--descriptor", default="fpfh", type=str)
    parser.add_argument("--num_node", default=20000, type=int)
    parser.add_argument("--use_icp", default=False, type=str2bool)
    parser.add_argument("--fused", default="auto", type=str, choices=("auto", "true", "false"),
                        help="fused-attention kernels: auto = on when the device is CUDA")
    parser.add_argument("--save_traj", default=False, type=str2bool,
                        help="write the optimized fragment trajectory to "
                             "logs/<scene>_traj.log (Redwood .log format)")
    parser.add_argument("--scenes", default=_cli.SCENES, type=str)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.data.redwood import RedwoodDataset
    from pointdsc_tpu_torch.eval.redwood_protocol import write_trajectory
    from pointdsc_tpu_torch.multiway.ate import ate_rmse
    from pointdsc_tpu_torch.multiway.registration import (
        MultiwayConfig,
        build_pose_graph,
        refine_and_reoptimize,
    )

    dev = resolve_device(args.device)
    cfg, model = _cli.load_model(args)
    fused = args.fused == "true" or (args.fused == "auto" and dev.type == "cuda")
    ates = []
    for scene in args.scenes.split(","):
        print(f"=== Scene {scene} ===")
        dataset = RedwoodDataset(root=args.root, select_scene=scene, descriptor=cfg.descriptor,
                                 in_dim=cfg.in_dim, inlier_threshold=cfg.inlier_threshold,
                                 num_node=args.num_node, use_mutual=True, device=dev)
        fragment_points = {i: dataset._load(i)[0] for i in range(dataset.num_pcds)}
        # odometry pairs get ICP from this estimate inside build_pose_graph (the
        # reference seeds them from per-fragment pose-graph files,
        # test_multi_ate.py:117-125, which the model's estimate replaces)
        pairwise, model = register_pairs(model, dataset, fused, dev)
        mcfg = MultiwayConfig()
        graph = build_pose_graph(dataset.num_pcds, pairwise, fragment_points, mcfg, device=dev)
        if args.use_icp:
            graph = refine_and_reoptimize(graph, fragment_points, mcfg, device=dev)
        ate = ate_rmse(graph.poses, dataset.gt_trajectory, device=dev)
        print(f"Scene {scene}: ATE RMSE = {ate:.2f} cm ({len(graph.edges)} edges kept)")
        if args.save_traj:
            os.makedirs("logs", exist_ok=True)
            write_trajectory(os.path.join("logs", f"{scene}_traj.log"), graph.poses)
        ates.append(ate)

    print(f"Mean ATE over {len(ates)} scenes: {np.mean(ates):.2f} cm")
    return ates


if __name__ == "__main__":
    main()
