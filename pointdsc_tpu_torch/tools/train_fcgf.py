"""Train VoxelFCGF on synthetic surfaces and measure descriptor quality
(counterpart of the JAX package's ``tools/train_fcgf.py``).

Random structured surfaces (a height field and boxes), two augmented views
each (a rotation of at most --max_rot_deg, the gravity-aligned indoor
regime, and 4 mm jitter), the hardest-contrastive loss with Adam; then the
nearest-neighbour matching inlier ratio on held-out pairs against FPFH on
the same clouds. The checkpoint is the flax file the reference writes
(``cal_fcgf --checkpoint`` and the JAX package read it). From the same
``np.random.default_rng`` state the scene and pair functions draw the arrays
the reference's draw.

    python -m pointdsc_tpu_torch.tools.train_fcgf --steps 300 --out fcgf_synth.pkl \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from pointdsc_tpu_torch.data import transforms_np as T
from pointdsc_tpu_torch.descriptors.fcgf import voxelize


def make_scene(rng, extent=2.8, spacing=0.02):
    """Random bumpy height field + boxes: locally distinctive geometry."""
    xs = np.arange(0.15, extent, spacing)
    xx, yy = np.meshgrid(xs, xs)
    z = np.zeros_like(xx)
    for _ in range(6):
        fx, fy = rng.uniform(1.0, 5.0, 2)
        px, py = rng.uniform(0, np.pi, 2)
        z += rng.uniform(0.02, 0.12) * np.sin(fx * xx + px) * np.cos(fy * yy + py)
    pts = [np.stack([xx, yy, z + 0.4], -1).reshape(-1, 3)]
    for _ in range(rng.integers(2, 5)):  # boxes standing on the field
        cx, cy = rng.uniform(0.5, extent - 0.5, 2)
        w, d, h = rng.uniform(0.15, 0.5, 3)
        for face in range(5):  # 4 sides + top
            u = np.arange(0, 1, spacing / max(w, d, h))
            uu, vv = np.meshgrid(u, u)
            if face == 4:
                p = np.stack([cx + (uu - 0.5) * w, cy + (vv - 0.5) * d,
                              np.full_like(uu, 0.4 + h)], -1)
            elif face in (0, 1):
                sign = -0.5 if face == 0 else 0.5
                p = np.stack([cx + (uu - 0.5) * w, np.full_like(uu, cy + sign * d),
                              0.4 + vv * h], -1)
            else:
                sign = -0.5 if face == 2 else 0.5
                p = np.stack([np.full_like(uu, cx + sign * w), cy + (uu - 0.5) * d,
                              0.4 + vv * h], -1)
            pts.append(p.reshape(-1, 3))
    cloud = np.concatenate(pts).astype(np.float32)
    return cloud + rng.normal(size=cloud.shape).astype(np.float32) * 0.003


def random_pose(rng, max_rot_deg=30.0, max_trans=0.3):
    """A rotation of at most ``max_rot_deg`` about a uniform axis and a
    translation of at most ``max_trans`` a coordinate, [4, 4] float32."""
    angle = np.radians(max_rot_deg)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    theta = rng.uniform(-angle, angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    t = rng.uniform(-max_trans, max_trans, 3)
    return T.integrate_trans(R, t).astype(np.float32)


def make_pair(rng, voxel_size, grid_size, n_corr=768, max_rot_deg=30.0):
    """Two augmented views of one scene and matched voxel indices: (occ0,
    occ1 [1, D, D, D], i0, i1 [n_corr, 3] int32, ok [n_corr] bool, (view0,
    view1, pose))."""
    cloud = make_scene(rng)
    pose = random_pose(rng, max_rot_deg)
    view0 = cloud
    view1 = T.transform(cloud, pose).astype(np.float32)
    # independent jitter per view (sensor noise)
    view0 = view0 + rng.normal(size=view0.shape).astype(np.float32) * 0.004
    view1 = view1 + rng.normal(size=view1.shape).astype(np.float32) * 0.004

    occ0, _, orig0 = voxelize(view0, voxel_size, grid_size)
    occ1, _, orig1 = voxelize(view1, voxel_size, grid_size)

    sel = rng.choice(len(cloud), n_corr, replace=len(cloud) < n_corr)
    i0 = np.floor((view0[sel] - orig0) / voxel_size).astype(np.int32)
    i1 = np.floor((view1[sel] - orig1) / voxel_size).astype(np.int32)
    ok = np.all((i0 >= 0) & (i0 < grid_size) & (i1 >= 0) & (i1 < grid_size), -1)
    return occ0, occ1, i0, i1, ok, (view0, view1, pose)


def inlier_ratio(src_kp, src_f, tgt_kp, tgt_f, gt_trans, tau=0.10):
    """Share of source keypoints whose feature-space nearest neighbour lies
    within ``tau`` of its true position (numpy, float64 products)."""
    f0 = src_f / (np.linalg.norm(src_f, axis=1, keepdims=True) + 1e-9)
    f1 = tgt_f / (np.linalg.norm(tgt_f, axis=1, keepdims=True) + 1e-9)
    nn = np.argmax(f0 @ f1.T, axis=1)
    warped = T.transform(src_kp, gt_trans)
    d = np.linalg.norm(warped - tgt_kp[nn], axis=1)
    return float(np.mean(d < tau))


def evaluate(model, rng, voxel_size, grid_size, n_pairs=6, max_rot_deg=30.0, tau=0.10):
    """Mean inlier ratio of VoxelFCGF and of FPFH (on the model's device)
    over ``n_pairs`` held-out pairs."""
    from pointdsc_tpu_torch.descriptors.fcgf import extract_features
    from pointdsc_tpu_torch.descriptors.fpfh import extract_fpfh

    device = next(model.parameters()).device
    rows = []
    for _ in range(n_pairs):
        *_, (v0, v1, pose) = make_pair(rng, voxel_size, grid_size, max_rot_deg=max_rot_deg)
        k0, f0 = extract_features(model, v0, voxel_size, grid_size)
        k1, f1 = extract_features(model, v1, voxel_size, grid_size)
        ir_fcgf = inlier_ratio(k0, f0, k1, f1, pose, tau)
        kp0, fp0 = extract_fpfh(v0, voxel_size=voxel_size, device=device)
        kp1, fp1 = extract_fpfh(v1, voxel_size=voxel_size, device=device)
        ir_fpfh = inlier_ratio(kp0, np.nan_to_num(fp0), kp1, np.nan_to_num(fp1), pose, tau)
        rows.append((ir_fcgf, ir_fpfh))
        print(f"  pair: VoxelFCGF {ir_fcgf:.3f} | FPFH {ir_fpfh:.3f}")
    arr = np.asarray(rows)
    return arr[:, 0].mean(), arr[:, 1].mean()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--voxel_size", type=float, default=0.05)
    ap.add_argument("--grid_size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max_rot_deg", type=float, default=30.0)
    ap.add_argument("--eval_pairs", type=int, default=6)
    ap.add_argument("--out", type=str, default="fcgf_synth.pkl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from pointdsc_tpu_torch.compat.fcgf_weights import save_fcgf_checkpoint
    from pointdsc_tpu_torch.descriptors.fcgf import VoxelFCGF
    from pointdsc_tpu_torch.descriptors.fcgf_train import make_fcgf_train_step

    rng = np.random.default_rng(args.seed)
    model = VoxelFCGF(out_dim=32, device=args.device,
                      generator=torch.Generator().manual_seed(args.seed))
    dev = next(model.parameters()).device
    step = make_fcgf_train_step(model, torch.optim.Adam(model.parameters(), lr=args.lr))
    g = args.grid_size
    t0 = time.time()
    for it in range(args.steps):
        occ0, occ1, i0, i1, ok, _ = make_pair(rng, args.voxel_size, g)
        metrics = step(torch.from_numpy(occ0)[None].to(dev), torch.from_numpy(occ1)[None].to(dev),
                       torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(ok))
        if (it + 1) % 25 == 0:
            print(f"[{it + 1}/{args.steps}] loss {float(metrics['loss']):.4f} "
                  f"pos {float(metrics['pos_dist']):.3f} "
                  f"neg {float(metrics['neg_dist']):.3f} ({time.time() - t0:.0f}s)")

    save_fcgf_checkpoint(model, args.out)
    print(f"saved {args.out}")

    print("held-out evaluation (NN-matching inlier ratio, tau=0.10):")
    eval_rng = np.random.default_rng(args.seed + 777)
    ir_fcgf, ir_fpfh = evaluate(model, eval_rng, args.voxel_size, g,
                                n_pairs=args.eval_pairs, max_rot_deg=args.max_rot_deg)
    print(f"RESULT VoxelFCGF inlier ratio {ir_fcgf:.3f} | FPFH {ir_fpfh:.3f}")
    return ir_fcgf, ir_fpfh


if __name__ == "__main__":
    main()
