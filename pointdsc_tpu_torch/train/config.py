"""Config / snapshot system (the port's own copy of
``pointdsc_tpu/train/config.py``, pure Python).

The same field names and the same JSON round trip, so a ``config.json``
written by either package loads in the other; the 3DMatch/KITTI default
switch of the reference's grouped-argparse config is kept.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass


@dataclass
class Config:
    # Snapshot
    exp_id: str = ""
    snapshot_dir: str = ""
    tboard_dir: str = ""
    save_dir: str = ""
    snapshot_interval: int = 1

    # Network (reference config.py:29-35)
    in_dim: int = 6
    num_layers: int = 12
    num_channels: int = 128
    num_iterations: int = 10
    ratio: float = 0.1
    k: int = 40

    # Loss (config.py:38-44)
    evaluate_interval: int = 1
    balanced: bool = False
    weight_classification: float = 1.0
    weight_spectralmatching: float = 1.0
    weight_transformation: float = 0.0
    transformation_loss_start_epoch: int = 0

    # Optimizer (config.py:47-57)
    optimizer: str = "ADAM"
    max_epoch: int = 50
    training_max_iter: int = 3500
    val_max_iter: int = 1000
    lr: float = 1e-4
    weight_decay: float = 1e-6
    momentum: float = 0.9
    scheduler: str = "ExpLR"
    scheduler_gamma: float = 0.99
    scheduler_interval: int = 1

    # Data (config.py:60-84)
    dataset: str = "3DMatch"
    root: str = "/data/3DMatch"
    descriptor: str = "fcgf"
    inlier_threshold: float = 0.10
    sigma_d: float = 0.10
    downsample: float = 0.03
    re_thre: float = 15.0
    te_thre: float = 30.0
    num_node: int = 1000
    use_mutual: bool = False
    augment_axis: int = 3
    augment_rotation: float = 1.0
    augment_translation: float = 0.5
    batch_size: int = 16
    num_workers: int = 16

    # Eval-time extras
    nms_radius: float = 0.10
    seed: int = 51

    # Misc
    verbose: bool = True
    pretrain: str = ""

    # Execution (not in the reference)
    # data-parallel processes (torch.distributed), 0 = the whole world (1 without one)
    num_devices: int = 0
    half_precision: bool = False  # bf16 activations in the encoder
    fused_attention: bool = False  # attention kernels with backward kernels, no [B,N,N]
    fused_sm_loss: bool = False  # tile-wise SM-loss kernels (no [B,N,N])
    remat: bool = False  # rematerialize encoder layers (training memory)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})


_KITTI_OVERRIDES = dict(
    root="/data/KITTI",
    inlier_threshold=1.2,
    sigma_d=1.2,
    downsample=0.30,
    re_thre=5.0,
    te_thre=60.0,
    max_epoch=100,
    nms_radius=1.2,
)


def default_config(dataset: str = "3DMatch") -> Config:
    """Dataset-switched defaults, mirroring config.py:61-76."""
    cfg = Config(dataset=dataset)
    if dataset == "KITTI":
        for k, v in _KITTI_OVERRIDES.items():
            setattr(cfg, k, v)
    if not cfg.exp_id:
        cfg.exp_id = f"PointDSC_{dataset}_{time.strftime('%m%d%H%M')}"
        cfg.snapshot_dir = f"snapshot/{cfg.exp_id}"
        cfg.tboard_dir = f"tensorboard/{cfg.exp_id}"
        cfg.save_dir = os.path.join(cfg.snapshot_dir, "models")
    return cfg


def get_config(dataset: str = "3DMatch", argv=None) -> Config:
    """CLI front end with the reference's flag names."""
    cfg = default_config(dataset)
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        default = getattr(cfg, f.name)
        if f.type == "bool" or isinstance(default, bool):
            parser.add_argument(
                f"--{f.name}",
                type=lambda v: v.lower() in ("true", "1"),
                default=default,
            )
        else:
            parser.add_argument(f"--{f.name}", type=type(default), default=default)
    args = parser.parse_args(argv)
    out = Config(**vars(args))
    # Re-derive dependent paths the user didn't set explicitly, so
    # `--exp_id X` or `--snapshot_dir Y` moves the whole snapshot tree
    # instead of leaving checkpoints/tensorboard at the stale default.
    if out.exp_id != cfg.exp_id and out.snapshot_dir == cfg.snapshot_dir:
        out.snapshot_dir = f"snapshot/{out.exp_id}"
    if out.exp_id != cfg.exp_id and out.tboard_dir == cfg.tboard_dir:
        out.tboard_dir = f"tensorboard/{out.exp_id}"
    if out.snapshot_dir != cfg.snapshot_dir and out.save_dir == cfg.save_dir:
        out.save_dir = os.path.join(out.snapshot_dir, "models")
    return out
