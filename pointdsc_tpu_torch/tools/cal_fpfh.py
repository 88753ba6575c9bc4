"""Batch FPFH descriptor preparation (counterpart of the JAX package's
``tools/cal_fpfh.py``).

Walks a dataset root and writes ``<name>_fpfh.npz`` files (keys: points, xyz,
feature) where the datasets read them:

  3dmatch       {root}/threedmatch/*.npz ('pcd' key)
                -> {root}/threedmatch_feat/<name>_fpfh.npz
  3dmatch_test  {root}/fragments/<scene>/*.ply  -> _fpfh.npz beside the ply
  redwood       {root}/<scene>/fragments/*.ply  -> _fpfh.npz beside the ply

    python -m pointdsc_tpu_torch.tools.cal_fpfh --job 3dmatch_test --root R \\
        [--scenes all] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from pointdsc_tpu_torch.data.ply import read_ply_xyz
from pointdsc_tpu_torch.data.redwood import REDWOOD_SCENES
from pointdsc_tpu_torch.data.threedmatch import TEST_SCENES
from pointdsc_tpu_torch.descriptors.fpfh import extract_fpfh


def write_features(out_path: str, points: np.ndarray, xyz: np.ndarray, feature: np.ndarray,
                   verbose: bool = True) -> None:
    """One cloud's descriptor file (keys: points, xyz, feature; float32)."""
    np.savez_compressed(out_path, points=np.asarray(points, np.float32),
                        xyz=np.asarray(xyz, np.float32), feature=np.asarray(feature, np.float32))
    if verbose:
        print(out_path, feature.shape)


def job_clouds(job: str, root: str, scenes=None, suffix: str = "fpfh"):
    """(points [P, 3], output path) of every cloud a job walks, in the
    reference's order: sorted files, scenes in the given order."""
    if job == "3dmatch":
        out_dir = os.path.join(root, "threedmatch_feat")
        os.makedirs(out_dir, exist_ok=True)
        for path in sorted(glob.glob(os.path.join(root, "threedmatch", "*.npz"))):
            data = np.load(path)
            if "pcd" not in data:
                continue
            name = os.path.basename(path).replace(".npz", f"_{suffix}.npz")
            yield data["pcd"], os.path.join(out_dir, name)
    elif job in ("3dmatch_test", "redwood"):
        for scene in scenes or (TEST_SCENES if job == "3dmatch_test" else REDWOOD_SCENES):
            pattern = (os.path.join(root, "fragments", scene, "*.ply") if job == "3dmatch_test"
                       else os.path.join(root, scene, "fragments", "*.ply"))
            for path in sorted(glob.glob(pattern)):
                yield read_ply_xyz(path), path.replace(".ply", f"_{suffix}.npz")
    else:
        raise ValueError(job)


def run_job(job: str, root: str, voxel_size: float = 0.05, scenes=None, verbose: bool = True,
            device: str = "cuda") -> int:
    """FPFH of every cloud of ``job`` under ``root``; returns the count."""
    n = 0
    for points, out_path in job_clouds(job, root, scenes, "fpfh"):
        if points.shape[0] == 0:
            print(f"{out_path}: empty cloud, skipped")
        else:
            xyz, feature = extract_fpfh(points, voxel_size=voxel_size, device=device)
            write_features(out_path, points, xyz, feature, verbose)
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--job", required=True, choices=["3dmatch", "3dmatch_test", "redwood"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--voxel_size", type=float, default=0.05)
    ap.add_argument("--scenes", type=str, default="all",
                    help="comma-separated scene list, or 'all'")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    scenes = None if args.scenes == "all" else args.scenes.split(",")
    n = run_job(args.job, args.root, args.voxel_size, scenes, device=args.device)
    print(f"wrote FPFH features for {n} fragments")
    return n


if __name__ == "__main__":
    main()
