"""Pairwise registration on Redwood / Augmented ICL-NUIM scenes (the port's
counterpart of the JAX package's ``multiway/test_multi.py``; the reference's
multiway/test_multi.py): every fragment pair is registered on its own and
scored with the 12-column protocol.

    python -m pointdsc_tpu_torch.multiway.test_multi --chosen_snapshot <id> \\
        --root R [--scenes a,b] [--num_node 5000] [--device cpu]

``--fused_attention auto`` runs the fused CUDA kernels when the device is
CUDA and the dense path on the CPU (the JAX CLI's Evaluator default).
"""

from __future__ import annotations

import argparse

import numpy as np

from pointdsc_tpu_torch.eval.runner import Evaluator
from pointdsc_tpu_torch.multiway import _cli


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chosen_snapshot", default="", type=str)
    parser.add_argument("--root", default="/data/Augmented_ICL-NUIM", type=str)
    parser.add_argument("--descriptor", default="fpfh", type=str)
    parser.add_argument("--num_node", default=5000, type=int)
    parser.add_argument("--scenes", default=_cli.SCENES, type=str)
    parser.add_argument("--fused_attention", default="auto", choices=["auto", "true", "false"],
                        help="the fused CUDA kernels (auto: on when the device is CUDA)")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.data.redwood import RedwoodDataset
    from pointdsc_tpu_torch.eval.protocol import aggregate_stats, format_scene_report

    dev = resolve_device(args.device)
    cfg, model = _cli.load_model(args)
    fused = args.fused_attention == "true" or (args.fused_attention == "auto"
                                               and dev.type == "cuda")
    all_stats = []
    scene_names = args.scenes.split(",")
    for scene_ind, scene in enumerate(scene_names):
        dataset = RedwoodDataset(root=args.root, select_scene=scene, descriptor=cfg.descriptor,
                                 in_dim=cfg.in_dim, inlier_threshold=cfg.inlier_threshold,
                                 num_node=args.num_node, use_mutual=True, device=dev)
        evaluator = Evaluator(model, re_thre=cfg.re_thre, te_thre=cfg.te_thre,
                              fused_attention=fused, device=dev)
        stats, agg = evaluator.run_dataset(dataset, scene_of=lambda i: scene_ind)
        print(f"Scene {scene}:")
        print(format_scene_report(agg))
        all_stats.append(stats)

    total = np.concatenate(all_stats)
    print("=== All scenes ===")
    agg = aggregate_stats(total, scene_names)
    print(format_scene_report(agg))
    return total, agg


if __name__ == "__main__":
    main()
