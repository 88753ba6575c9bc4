"""Train PointDSC on KITTI (the port's counterpart of the JAX package's
``train_KITTI.py``; the reference's train_KITTI.py differs from its 3DMatch
entry only in the dataset class).

    python -m pointdsc_tpu_torch.train_KITTI --root /data/KITTI [--device cpu] ...

Reads the ``{descriptor}_train`` and ``{descriptor}_val`` pair directories
(data/kitti_prep.py writes them) and writes ``config.json`` and the
checkpoints under ``snapshot/<exp_id>/``.
"""

from __future__ import annotations

from pointdsc_tpu_torch.train_3DMatch import fit, parse_args, start


def main(argv=None):
    from pointdsc_tpu_torch.data.kitti import KITTIDataset

    cfg, device = parse_args("KITTI", argv)
    start(cfg)
    sets = [KITTIDataset(
        root=cfg.root, split=split, descriptor=cfg.descriptor, in_dim=cfg.in_dim,
        inlier_threshold=cfg.inlier_threshold, num_node=cfg.num_node, use_mutual=cfg.use_mutual,
        augment_axis=cfg.augment_axis, augment_rotation=cfg.augment_rotation,
        augment_translation=cfg.augment_translation, device=device)
        for split in ("train", "val")]
    return fit(cfg, device, *sets)


if __name__ == "__main__":
    main()
