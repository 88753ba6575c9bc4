"""Batch FCGF descriptor preparation (counterpart of the JAX package's
``tools/cal_fcgf.py``).

The dataset walks of ``cal_fpfh`` with the VoxelFCGF network; writes
``<name>_fcgf.npz`` (keys: points, xyz, feature). A trained checkpoint (the
flax file of ``train_fcgf``, e.g. ``snapshot/fcgf_synth_release.pkl``) is
passed with --checkpoint; without one the network runs with random weights,
which only serves pipeline smoke tests, and the CLI warns.

    python -m pointdsc_tpu_torch.tools.cal_fcgf --job 3dmatch_test --root R \\
        --checkpoint snapshot/fcgf_synth_release.pkl [--device cpu]
"""

from __future__ import annotations

import argparse

from pointdsc_tpu_torch.descriptors.fcgf import (
    extract_features,
    extract_features_tiled,
    load_fcgf,
)
from pointdsc_tpu_torch.tools.cal_fpfh import job_clouds, write_features


def run_job(job: str, root: str, model, voxel_size: float = 0.05, grid_size: int = 96,
            tiled: bool = False, scenes=None, verbose: bool = True) -> int:
    """VoxelFCGF features of every cloud of ``job`` under ``root`` on the
    model's device; returns the count."""
    n = 0
    for points, out_path in job_clouds(job, root, scenes, "fcgf"):
        if points.shape[0] == 0:
            print(f"{out_path}: empty cloud, skipped")
        else:
            extract = extract_features_tiled if tiled else extract_features
            xyz, feature = extract(model, points, voxel_size, grid_size)
            write_features(out_path, points, xyz, feature, verbose)
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--job", required=True, choices=["3dmatch", "3dmatch_test", "redwood"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--checkpoint", type=str, default="")
    ap.add_argument("--voxel_size", type=float, default=0.05)
    ap.add_argument("--grid_size", type=int, default=96)
    ap.add_argument("--out_dim", type=int, default=32)
    ap.add_argument("--tiled", action="store_true",
                    help="overlapping-tile extraction for large extents")
    ap.add_argument("--scenes", type=str, default="all")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    model = load_fcgf(args.checkpoint or None, args.out_dim, device=args.device)
    scenes = None if args.scenes == "all" else args.scenes.split(",")
    n = run_job(args.job, args.root, model, args.voxel_size, args.grid_size, args.tiled, scenes)
    print(f"wrote FCGF features for {n} fragments")
    return n


if __name__ == "__main__":
    main()
