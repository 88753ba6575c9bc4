"""3DMatch benchmark CLI (the port's counterpart of the JAX package's
``evaluation/test_3DMatch.py``; the reference's evaluation/test_3DMatch.py).

    python -m pointdsc_tpu_torch.evaluation.test_3DMatch --chosen_snapshot <id> \\
        [--root R] [--use_icp true] [--save_npy true] [--device cpu]

Loads ``snapshot/<id>/config.json`` and ``models/model_best.pkl``, evaluates
the 8 test scenes (those with a gt.log) with the 12-column stats protocol and
appends the report to ``logs/<id>-<solver>-<descriptor>[-ICP].log``.
"""

from __future__ import annotations

from pointdsc_tpu_torch.evaluation import _cli


def main(argv=None):
    args = _cli.parse(_cli.parser(__doc__.split("\n\n")[0]), argv)
    from pointdsc_tpu_torch.data.threedmatch import ThreeDMatchTest

    cfg = _cli.load_config(args)
    evaluator = _cli.make_evaluator(args, cfg, use_icp=args.use_icp, solver=args.solver)
    dataset = ThreeDMatchTest(root=cfg.root, descriptor=cfg.descriptor, in_dim=cfg.in_dim,
                              inlier_threshold=cfg.inlier_threshold, num_node="all",
                              use_mutual=cfg.use_mutual, device=args.device)
    suffix = "-ICP" if args.use_icp else ""
    log_path = f"logs/{args.chosen_snapshot}-{args.solver}-{cfg.descriptor}{suffix}.log"
    return _cli.evaluate(args, evaluator, dataset, log_path, scene_of=dataset.scene_of)


if __name__ == "__main__":
    main()
