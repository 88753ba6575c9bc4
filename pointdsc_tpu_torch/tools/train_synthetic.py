"""Training run on synthetic data at the reference training shape (counterpart
of the JAX package's ``tools/train_synthetic.py``).

Runs the Trainer (12 layers x 128 channels, bs 16, N = 1000 padded to 1024)
on synthetic registration pairs: the classification and SM losses must drop
and the val recall stay high. Writes a snapshot (``config.json`` and
checkpoints) that ``load_pretrained`` and the JAX package both load.

    python -m pointdsc_tpu_torch.tools.train_synthetic --fused_attention true \\
        --fused_sm_loss true [--kitti_regime true] [--device cpu]

``--kitti_regime``: N = 12288, bs 2, sigma_d 1.2, inlier radius 0.6 m, scenes
of half-width 50 m: the size at which the dense path's [B, N, N] tensors kept
for the backward pass no longer fit, and only the fused path trains.
"""

from __future__ import annotations

import argparse
import os


def _flag(v: str) -> bool:
    return v.lower() in ("true", "1")


class MixedRatios:
    """Round-robin mix of synthetic datasets with different inlier ratios."""

    def __init__(self, parts):
        self.parts = parts

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __getitem__(self, i):
        part = self.parts[i % len(self.parts)]
        return part[(i // len(self.parts)) % len(part)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--iters", type=int, default=150)
    parser.add_argument("--num_pairs", type=int, default=2400)
    parser.add_argument("--snapshot_dir", type=str, default="snapshot/synthetic_run")
    parser.add_argument("--exp_id", type=str, default="synthetic_run")
    parser.add_argument("--ratios", type=str, default="0.2,0.35,0.5",
                        help="comma-separated inlier ratios mixed into training")
    parser.add_argument("--fused_attention", type=_flag, default=False,
                        help="train through the attention kernels with backward kernels")
    parser.add_argument("--fused_sm_loss", type=_flag, default=False,
                        help="tile-wise SM-loss kernels (no [bs, N, N] tensor)")
    parser.add_argument("--remat", type=_flag, default=False)
    parser.add_argument("--kitti_regime", type=_flag, default=False,
                        help="N=12288, bs=2, sigma_d=1.2, tau=0.6 m, ~50 m scenes")
    parser.add_argument("--num_node", type=int, default=0, help="override correspondence count")
    parser.add_argument("--batch_size", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from pointdsc_tpu_torch.data import Loader, SyntheticPairDataset
    from pointdsc_tpu_torch.train.config import default_config
    from pointdsc_tpu_torch.train.trainer import Trainer
    from pointdsc_tpu_torch.utils.seed import set_seed

    cfg = default_config("KITTI" if args.kitti_regime else "3DMatch")
    if args.kitti_regime:
        cfg.num_node = 12288
        cfg.batch_size = 2
        cfg.inlier_threshold = 0.6
        cfg.sigma_d = 1.2
    if args.num_node:
        cfg.num_node = args.num_node
    if args.batch_size:
        cfg.batch_size = args.batch_size
    cfg.max_epoch = args.epochs
    cfg.training_max_iter = args.iters
    cfg.val_max_iter = 8
    cfg.snapshot_dir = args.snapshot_dir
    cfg.save_dir = os.path.join(args.snapshot_dir, "models")
    cfg.tboard_dir = os.path.join(args.snapshot_dir, "tb")
    cfg.exp_id = args.exp_id
    cfg.fused_attention = args.fused_attention
    cfg.fused_sm_loss = args.fused_sm_loss
    cfg.remat = args.remat
    set_seed(cfg.seed)
    os.makedirs(cfg.snapshot_dir, exist_ok=True)
    cfg.save(os.path.join(cfg.snapshot_dir, "config.json"))

    ratios = [float(r) for r in args.ratios.split(",")]
    per = max(1, args.num_pairs // len(ratios))
    # KITTI regime: LiDAR-scale coordinates and the 0.6 m inlier radius
    ds_kw = dict(num_corr=cfg.num_node)
    if args.kitti_regime:
        ds_kw.update(scene_scale=50.0, noise=0.05, inlier_threshold=cfg.inlier_threshold)
    train_ds = MixedRatios([
        SyntheticPairDataset(num_pairs=per, inlier_ratio=r, seed=17 * i, **ds_kw)
        for i, r in enumerate(ratios)])
    val_ds = MixedRatios([
        SyntheticPairDataset(num_pairs=64, inlier_ratio=r, seed=9999 + i, **ds_kw)
        for i, r in enumerate(ratios)])
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True, num_workers=8)
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, num_workers=8)

    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state(steps_per_epoch=len(train_loader))

    res0 = trainer.evaluate(val_loader, state)
    state = trainer.train(train_loader, val_loader, state)
    res1 = trainer.evaluate(val_loader, state)
    print(
        f"RESULT class_loss {res0['class_loss']:.4f} -> {res1['class_loss']:.4f} | "
        f"sm_loss {res0['sm_loss']:.4f} -> {res1['sm_loss']:.4f} | "
        f"f1 {res0['f1']:.3f} -> {res1['f1']:.3f} | "
        f"recall {res0['reg_recall']:.1f} -> {res1['reg_recall']:.1f}"
    )
    return res0, res1


if __name__ == "__main__":
    main()
