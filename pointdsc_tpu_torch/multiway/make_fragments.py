"""Fragment-building CLI: RGB-D scene directory -> fused fragment clouds (the
port's counterpart of the JAX package's ``multiway/make_fragments.py``; the
reference's multiway/make_fragments.py:182-198).

    python -m pointdsc_tpu_torch.multiway.make_fragments --config scene_config.json
    python -m pointdsc_tpu_torch.multiway.make_fragments --path_dataset /data/scene1 \\
        [--device cpu]

The config JSON is the reference's (``path_dataset``, ``n_frames_per_fragment``,
``tsdf_cubic_size``, ``path_intrinsic``); an explicit flag wins over it. Output
goes to ``<path_dataset>/fragments/``: ``fragment_%03d.ply``, the
``fragment_%03d.npy`` world pose and an FPFH ``fragment_%03d_fpfh.npz``, the
layout the Redwood loader and the multiway CLIs read. The scene needs a
``depth/`` folder of 16-bit millimeter PNGs; an ``image/`` (or ``rgb/``,
``color/``) folder of matching color frames switches odometry to the hybrid
photometric + geometric objective.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default=None, help="reference-style config JSON")
    parser.add_argument("--path_dataset", default=None)
    parser.add_argument("--out_dir", default=None, help="default: <path_dataset>/fragments")
    parser.add_argument("--n_frames_per_fragment", default=None, type=int,
                        help="default 100; an explicit flag wins over the config JSON")
    parser.add_argument("--voxel_size", default=None, type=float,
                        help="TSDF voxel size (m), default 0.008; the reference derives it "
                             "as tsdf_cubic_size / 512. An explicit flag wins over the "
                             "config JSON")
    parser.add_argument("--fpfh_voxel", default=0.05, type=float)
    parser.add_argument("--path_intrinsic", default=None,
                        help="JSON with width/height/fx/fy/cx/cy (default: PrimeSense)")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    # precedence: explicit flag > config JSON > built-in default
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
        args.path_dataset = args.path_dataset or cfg.get("path_dataset")
        if args.n_frames_per_fragment is None:
            args.n_frames_per_fragment = cfg.get("n_frames_per_fragment")
        if args.voxel_size is None and "tsdf_cubic_size" in cfg:
            args.voxel_size = float(cfg["tsdf_cubic_size"]) / 512.0
        args.path_intrinsic = args.path_intrinsic or cfg.get("path_intrinsic")
    if args.n_frames_per_fragment is None:
        args.n_frames_per_fragment = 100
    if args.voxel_size is None:
        args.voxel_size = 0.008
    if not args.path_dataset:
        parser.error("need --path_dataset or a config with path_dataset")

    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.fusion.camera import PinholeIntrinsics
    from pointdsc_tpu_torch.fusion.fragments import make_fragments

    dev = resolve_device(args.device)
    intr = None
    if args.path_intrinsic:
        with open(args.path_intrinsic) as f:
            k = json.load(f)
        if "intrinsic_matrix" in k:  # Open3D camera JSON (column-major)
            m = k["intrinsic_matrix"]
            intr = PinholeIntrinsics(int(k["width"]), int(k["height"]), float(m[0]),
                                     float(m[4]), float(m[6]), float(m[7]))
        else:
            intr = PinholeIntrinsics(int(k["width"]), int(k["height"]), float(k["fx"]),
                                     float(k["fy"]), float(k["cx"]), float(k["cy"]))

    out_dir = args.out_dir or os.path.join(args.path_dataset, "fragments")
    make_fragments(args.path_dataset, out_dir, n_frames_per_fragment=args.n_frames_per_fragment,
                   voxel_size=args.voxel_size, fpfh_voxel=args.fpfh_voxel, intr=intr, device=dev)
    print(f"fragments written to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
