"""Classical baselines on KITTI (the port's counterpart of the JAX
package's ``baseline_scripts/baseline_KITTI.py``; the reference's
baseline_scripts/baseline_KITTI.py).

    python -m pointdsc_tpu_torch.baseline_scripts.baseline_KITTI --method RANSAC \\
        --root R [--split test] [--num_node 15000] [--save_npy true] [--device cpu]

The methods of the 3DMatch baseline CLI under the reference's outdoor
protocol: inlier threshold 0.6 m, success at RE < 5 deg and TE < 60 cm,
15000 correspondences (baseline_KITTI.py:26-27,103) and the SM top ratio
0.05 (baseline_KITTI.py:50). ``--save_npy`` writes
``logs/baseline-kitti-<method>-<descriptor>.npy``.
"""

from __future__ import annotations

import argparse

from pointdsc_tpu_torch.baseline_scripts._runner import add_common_flags, run_baseline


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_flags(parser, method="RANSAC", root="/data/KITTI", num_node=15000,
                     inlier_threshold=0.60, re_thre=5.0, te_thre=60.0)
    parser.add_argument("--split", default="test", type=str)
    args = parser.parse_args(argv)

    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.data.kitti import KITTIDataset
    from pointdsc_tpu_torch.utils.seed import set_seed

    device = resolve_device(args.device)
    set_seed(51)
    dataset = KITTIDataset(root=args.root, split=args.split, descriptor=args.descriptor,
                           inlier_threshold=args.inlier_threshold, num_node=args.num_node,
                           use_mutual=False, augment_axis=0, augment_rotation=0.0,
                           augment_translation=0.0, device=args.device)
    return run_baseline(dataset, ["KITTI"], lambda i: 0, args, device,
                        sm_top_ratio=0.05,  # reference baseline_KITTI.py:50
                        save_tag="-kitti")


if __name__ == "__main__":
    main()
