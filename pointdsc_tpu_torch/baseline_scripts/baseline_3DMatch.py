"""Classical baselines on 3DMatch (the port's counterpart of the JAX
package's ``baseline_scripts/baseline_3DMatch.py``; the reference's
baseline_scripts/baseline_3DMatch.py).

    python -m pointdsc_tpu_torch.baseline_scripts.baseline_3DMatch --method SM \\
        --root R [--num_node 2048] [--gc_minimizer exact] [--save_npy true] [--device cpu]

Methods: SM (spectral matching), RANSAC (the hypothesis sweep on the
device), GCRANSAC (RANSAC with a spatially coherent labelling and local
optimisation), LS (least squares on the gt inliers), PMC (the native exact
max clique). The same 12-column stats protocol as the model's evaluation;
``--save_npy`` writes ``logs/baseline-<method>-<descriptor>.npy``.
"""

from __future__ import annotations

import argparse

from pointdsc_tpu_torch.baseline_scripts._runner import add_common_flags, run_baseline


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_flags(parser, method="SM", root="/data/3DMatch", num_node=2048,
                     inlier_threshold=0.10, re_thre=15.0, te_thre=30.0)
    args = parser.parse_args(argv)

    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.data.threedmatch import ThreeDMatchTest
    from pointdsc_tpu_torch.utils.seed import set_seed

    device = resolve_device(args.device)
    set_seed(51)
    dataset = ThreeDMatchTest(root=args.root, descriptor=args.descriptor,
                              inlier_threshold=args.inlier_threshold, num_node=args.num_node,
                              use_mutual=False, device=args.device)
    # the reference baseline_3DMatch.py's SM top ratio
    return run_baseline(dataset, dataset.scene_list, dataset.scene_of, args, device,
                        sm_top_ratio=0.1)


if __name__ == "__main__":
    main()
