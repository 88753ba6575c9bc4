"""KITTI benchmark CLI (the port's counterpart of the JAX package's
``evaluation/test_KITTI.py``; the reference's evaluation/test_KITTI.py).

    python -m pointdsc_tpu_torch.evaluation.test_KITTI --chosen_snapshot <id> \\
        [--root R] [--num_node 12000] [--device cpu]

Evaluates the ``{descriptor}_test`` pairs with the reference's cross-dataset
settings (test_KITTI.py:166-170): inlier threshold 0.6 m, sigma_d 1.2,
RE < 5 deg, TE < 60 cm. Appends the report to
``logs/<id>-<solver>-<descriptor>-KITTI.log``.
"""

from __future__ import annotations

from pointdsc_tpu_torch.evaluation import _cli


def main(argv=None):
    p = _cli.parser(__doc__.split("\n\n")[0])
    p.add_argument("--num_node", default=12000, type=int)
    args = _cli.parse(p, argv)
    from pointdsc_tpu_torch.data.kitti import KITTIDataset

    cfg = _cli.load_config(args)
    cfg.inlier_threshold = 0.6
    cfg.sigma_d = 1.2
    cfg.re_thre = 5.0
    cfg.te_thre = 60.0
    evaluator = _cli.make_evaluator(args, cfg, use_icp=args.use_icp, solver=args.solver)
    dataset = KITTIDataset(root=cfg.root, split="test", descriptor=cfg.descriptor,
                           in_dim=cfg.in_dim, inlier_threshold=cfg.inlier_threshold,
                           num_node=args.num_node, use_mutual=cfg.use_mutual, augment_axis=0,
                           augment_rotation=0.0, augment_translation=0.0, device=args.device)
    log_path = f"logs/{args.chosen_snapshot}-{args.solver}-{cfg.descriptor}-KITTI.log"
    return _cli.evaluate(args, evaluator, dataset, log_path)


if __name__ == "__main__":
    main()
