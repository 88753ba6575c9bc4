"""Train PointDSC on 3DMatch (the port's counterpart of the JAX package's
``train_3DMatch.py``; the reference's train_3DMatch.py).

    python -m pointdsc_tpu_torch.train_3DMatch --root /data/3DMatch --descriptor fcgf \\
        [--fused_attention true --fused_sm_loss true] [--device cpu] ...

The flags are the Config's fields (train/config.py) plus ``--device``. Writes
``config.json``, copies of the training sources and the checkpoints
(``models/model_<epoch>.pkl``, ``model_best.pkl``) under ``snapshot/<exp_id>/``
as the reference does (train_3DMatch.py:21-33). The scenes are those of the
packaged split files (``data/splits/{train,val}_3dmatch.txt``).
"""

from __future__ import annotations

import argparse
import os
import shutil

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.data.pipeline import Loader
from pointdsc_tpu_torch.train.config import get_config
from pointdsc_tpu_torch.train.trainer import Trainer
from pointdsc_tpu_torch.utils.seed import set_seed

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("train_3DMatch.py", "train/trainer.py", "train/losses.py", "models/pointdsc.py",
           "data/threedmatch.py")


def _copy_sources(snapshot_dir):
    """Copy the training sources of this package into the snapshot directory
    (reference train_3DMatch.py:24-33)."""
    for rel in SOURCES:
        shutil.copy2(os.path.join(HERE, rel), os.path.join(snapshot_dir, os.path.basename(rel)))


def parse_args(dataset: str, argv):
    """(Config, device): ``--device`` (default cuda, which raises without a
    card) beside the Config's flags."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", type=str)
    known, rest = pre.parse_known_args(argv)
    return get_config(dataset, rest), resolve_device(known.device)


def start(cfg, copy_sources: bool = False) -> None:
    """Seed, snapshot directories and ``config.json``."""
    set_seed(cfg.seed)
    os.makedirs(cfg.snapshot_dir, exist_ok=True)
    os.makedirs(cfg.save_dir, exist_ok=True)
    cfg.save(os.path.join(cfg.snapshot_dir, "config.json"))
    if copy_sources:
        _copy_sources(cfg.snapshot_dir)


def fit(cfg, device, train_set, val_set):
    """Loaders over both splits (the train one shuffled) and the Trainer's
    epochs. Returns the final TrainState."""
    train_loader = Loader(train_set, cfg.batch_size, shuffle=True, num_workers=cfg.num_workers)
    val_loader = Loader(val_set, cfg.batch_size, shuffle=False, num_workers=cfg.num_workers)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(steps_per_epoch=len(train_loader))
    return trainer.train(train_loader, val_loader, state)


def main(argv=None):
    from pointdsc_tpu_torch.data.threedmatch import ThreeDMatchTrainVal

    cfg, device = parse_args("3DMatch", argv)
    start(cfg, copy_sources=True)
    sets = [ThreeDMatchTrainVal(
        root=cfg.root, split=split, descriptor=cfg.descriptor, in_dim=cfg.in_dim,
        inlier_threshold=cfg.inlier_threshold, num_node=cfg.num_node, use_mutual=cfg.use_mutual,
        augment_axis=cfg.augment_axis, augment_rotation=cfg.augment_rotation,
        augment_translation=cfg.augment_translation, device=device)
        for split in ("train", "val")]
    return fit(cfg, device, *sets)


if __name__ == "__main__":
    main()
