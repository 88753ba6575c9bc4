"""What the two Redwood registration CLIs share: the scene list, the snapshot's
config and the model with its weights.

A snapshot is ``snapshot/<id>/config.json`` and
``snapshot/<id>/models/model_best.pkl``, relative to the working directory.
Without ``--chosen_snapshot`` (or without its weights) the model of the
3DMatch default config gets random weights from a generator seeded 0, as the
JAX CLIs take ``model.init(key(0))``; the two draws differ.
"""

from __future__ import annotations

import os

SCENES = ("livingroom1-simulated,livingroom2-simulated,office1-simulated,"
          "office2-simulated")


def load_model(args):
    """(Config, PointDSC on ``args.device``) for ``args.chosen_snapshot``,
    with ``cfg.descriptor`` set from ``args.descriptor``."""
    import torch

    from pointdsc_tpu_torch.models import PointDSC
    from pointdsc_tpu_torch.train.config import Config, default_config
    from pointdsc_tpu_torch.train.trainer import load_model_weights

    if args.chosen_snapshot:
        cfg = Config.load(f"snapshot/{args.chosen_snapshot}/config.json")
    else:
        cfg = default_config("3DMatch")
    cfg.descriptor = args.descriptor
    ckpt = f"snapshot/{args.chosen_snapshot}/models/model_best.pkl"
    trained = bool(args.chosen_snapshot) and os.path.exists(ckpt)
    model = PointDSC(in_dim=cfg.in_dim, num_layers=cfg.num_layers,
                     num_channels=cfg.num_channels, num_iterations=cfg.num_iterations,
                     ratio=cfg.ratio, sigma_d=cfg.sigma_d, k=cfg.k,
                     inlier_threshold=cfg.inlier_threshold, nms_radius=cfg.inlier_threshold,
                     device=args.device,
                     generator=None if trained else torch.Generator().manual_seed(0))
    if trained:
        load_model_weights(model, ckpt)
    return cfg, model.eval()
