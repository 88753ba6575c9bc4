"""3DLoMatch benchmark CLI (the port's counterpart of the JAX package's
``evaluation/test_3DLoMatch.py``): 1781 low-overlap pairs, with FCGF
fragments or OverlapPredator's per-pair correspondences.

    python -m pointdsc_tpu_torch.evaluation.test_3DLoMatch --chosen_snapshot <id> \\
        [--num_corr 5000] [--use_predator true --predator_root P] [--device cpu]

Appends the report to ``logs/<id>-3DLoMatch-<descriptor>.log``.
"""

from __future__ import annotations

from pointdsc_tpu_torch.evaluation import _cli


def main(argv=None):
    p = _cli.parser(__doc__.split("\n\n")[0], solver=False)
    p.add_argument("--num_corr", default=5000, type=int)
    p.add_argument("--use_predator", default=False, type=_cli.str2bool,
                   help="OverlapPredator's per-pair .pth correspondences (reference "
                        "test_3DLoMatch.py:22-60); --predator_root is their directory")
    p.add_argument("--predator_root", default="", type=str)
    args = _cli.parse(p, argv)

    cfg = _cli.load_config(args)
    evaluator = _cli.make_evaluator(args, cfg)
    if args.use_predator:
        from pointdsc_tpu_torch.data.predator import PredatorLoMatchDataset

        dataset = PredatorLoMatchDataset(root=args.predator_root, n_points=args.num_corr,
                                         inlier_threshold=cfg.inlier_threshold, in_dim=cfg.in_dim)
    else:
        from pointdsc_tpu_torch.data.threedmatch import ThreeDLoMatchTest

        dataset = ThreeDLoMatchTest(root=cfg.root, descriptor=cfg.descriptor, in_dim=cfg.in_dim,
                                    inlier_threshold=cfg.inlier_threshold,
                                    num_node=args.num_corr, use_mutual=cfg.use_mutual,
                                    device=args.device)
    log_path = f"logs/{args.chosen_snapshot}-3DLoMatch-{cfg.descriptor}.log"
    return _cli.evaluate(args, evaluator, dataset, log_path)


if __name__ == "__main__":
    main()
