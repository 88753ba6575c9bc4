"""Trainer: train and eval steps on one card, and the host-side epoch loop
(PyTorch counterpart of ``pointdsc_tpu/train/trainer.py``).

Kept from the reference and the JAX package:
  * eval before training at epoch 0, best snapshot by val registration recall;
  * the optimizer step is skipped when any gradient is non-finite: parameters,
    optimizer moments and the schedule's count stay, the BatchNorm running
    statistics of that forward do advance;
  * exponential learning-rate decay in a staircase that steps once per epoch
    of optimizer steps actually taken;
  * snapshot naming ``model_<epoch>.pkl`` / ``model_best.pkl``, in the JAX
    package's checkpoint layout (``params``, ``batch_stats``, ``step``), so
    either package loads the other's weights.

The finite-gradient check costs one host read per step, the only one: the
metrics stay on the device between log points.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.compat import flax_msgpack
from pointdsc_tpu_torch.compat.weights import from_flax_variables, to_flax_variables
from pointdsc_tpu_torch.kernels.sm_loss import fused_spectral_matching_loss
from pointdsc_tpu_torch.models.pointdsc import PointDSC
from pointdsc_tpu_torch.train.config import Config
from pointdsc_tpu_torch.train.losses import (
    classification_loss,
    classification_metrics,
    spectral_matching_loss,
    transformation_loss,
)
from pointdsc_tpu_torch.utils.logging import MetricsLogger
from pointdsc_tpu_torch.utils.timer import AverageMeter, Timer

LOG_EVERY = 100  # the reference's logging cadence, in iterations
_BATCH_DTYPES = {"mask": torch.bool}


class TrainState(NamedTuple):
    model: PointDSC
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int  # train steps taken, skipped ones included


def make_optimizer(cfg: Config, params, steps_per_epoch: int):
    """(optimizer, scheduler). ADAM (eps 1e-8) or SGD with momentum, weight
    decay added to the gradient before the moments. The learning rate decays
    by ``scheduler_gamma`` every ``min(training_max_iter, steps_per_epoch) *
    scheduler_interval`` optimizer steps, so ``scheduler.step()`` follows
    every optimizer step, not every epoch."""
    if cfg.optimizer == "SGD":
        optimizer = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                                    weight_decay=cfg.weight_decay)
    else:
        optimizer = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8,
                                     weight_decay=cfg.weight_decay)
    transition = max(1, min(cfg.training_max_iter, steps_per_epoch) * cfg.scheduler_interval)
    gamma = cfg.scheduler_gamma
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: gamma ** (s // transition))
    return optimizer, scheduler


class Trainer:
    def __init__(self, cfg: Config, model: PointDSC | None = None,
                 device: str | torch.device = "cuda"):
        if cfg.num_devices > 1:
            raise NotImplementedError(
                "num_devices > 1: data-parallel training over several cards is not ported "
                "(ROADMAP.md, Queue A 12)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model
        self.logger = MetricsLogger(cfg.tboard_dir) if cfg.tboard_dir else None

    # ------------------------------------------------------------------
    def init_state(self, steps_per_epoch: int, seed: int = 0) -> TrainState:
        """A model with random weights drawn from ``seed`` (unless the Trainer
        was given one), its optimizer and schedule; ``cfg.pretrain`` is loaded
        over them when set."""
        cfg = self.cfg
        model = self.model
        if model is None:
            model = PointDSC(
                in_dim=cfg.in_dim, num_layers=cfg.num_layers, num_channels=cfg.num_channels,
                num_iterations=cfg.num_iterations, ratio=cfg.ratio,
                inlier_threshold=cfg.inlier_threshold, sigma_d=cfg.sigma_d, k=cfg.k,
                nms_radius=cfg.nms_radius, half_precision=cfg.half_precision, remat=cfg.remat,
                device=self.device, generator=torch.Generator().manual_seed(seed))
        model.to(self.device)
        optimizer, scheduler = make_optimizer(cfg, list(model.parameters()), steps_per_epoch)
        state = TrainState(model, optimizer, scheduler, 0)
        if cfg.pretrain:
            state = self.load_checkpoint(cfg.pretrain, state)
        return state

    def to_device(self, batch: dict) -> dict:
        """A collated numpy batch as tensors on the Trainer's device."""
        return {k: torch.as_tensor(v).to(device=self.device,
                                         dtype=_BATCH_DTYPES.get(k, torch.float32))
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def _losses(self, model: PointDSC, batch: dict):
        """Forward in the model's current mode and the three losses; returns
        (output, class_loss, sm_loss, transformation-loss tuple)."""
        cfg = self.cfg
        out = model(batch["corr_pos"], batch["src_keypts"], batch["tgt_keypts"],
                    mask=batch["mask"], testing=False, fused=cfg.fused_attention,
                    skip_M=cfg.fused_sm_loss)
        gt_labels, mask = batch["gt_labels"], batch["mask"]
        class_loss = classification_loss(out.final_labels, gt_labels, mask,
                                         balanced=cfg.balanced)
        # the reference wires config.balanced into both losses
        if cfg.fused_sm_loss:
            sm_loss = fused_spectral_matching_loss(out.normed_features, out.sigma, gt_labels,
                                                   mask, cfg.balanced)
        else:
            sm_loss = spectral_matching_loss(out.M, gt_labels, mask, balanced=cfg.balanced)
        tl = transformation_loss(out.final_trans, batch["gt_trans"], batch["src_keypts"],
                                 batch["tgt_keypts"], out.final_labels, mask,
                                 re_thre=cfg.re_thre, te_thre=cfg.te_thre)
        return out, class_loss, sm_loss, tl

    @staticmethod
    def _metrics(out, gt_labels, mask, class_loss, sm_loss, tl) -> dict:
        cm = classification_metrics(out.final_labels, gt_labels, mask)
        metrics = {"class_loss": class_loss, "sm_loss": sm_loss, "trans_loss": tl.loss,
                   "reg_recall": tl.recall, "re": tl.re, "te": tl.te, **cm}
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, state: TrainState, batch: dict, epoch: int):
        """One optimizer step on a device batch; returns (state, metrics), the
        metrics 0-d tensors on the device."""
        cfg = self.cfg
        model, optimizer, scheduler, step = state
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out, class_loss, sm_loss, tl = self._losses(model, batch)
        loss = cfg.weight_classification * class_loss + cfg.weight_spectralmatching * sm_loss
        # static: without it the backward graph ends at the two losses above
        if cfg.weight_transformation > 0.0 and epoch > cfg.transformation_loss_start_epoch:
            loss = loss + cfg.weight_transformation * tl.loss
        loss.backward()

        params = [p for group in optimizer.param_groups for p in group["params"]]
        for p in params:  # a parameter off the graph still decays, as a zero gradient would
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        finite = torch.stack([torch.isfinite(p.grad).all() for p in params]).all()
        if bool(finite):  # the step's one host read
            optimizer.step()
            scheduler.step()

        metrics = self._metrics(out, batch["gt_labels"], batch["mask"], class_loss, sm_loss, tl)
        metrics["loss"] = loss.detach()
        metrics["grad_finite"] = finite.float()
        return TrainState(model, optimizer, scheduler, step + 1), metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict) -> dict:
        """Eval-mode forward (``testing=False``) and the losses and metrics of
        one device batch. With ``fused_attention`` this runs the int8 cache
        and the whole-layer kernels on the current weights."""
        model = state.model
        model.eval()
        out, class_loss, sm_loss, tl = self._losses(model, batch)
        return self._metrics(out, batch["gt_labels"], batch["mask"], class_loss, sm_loss, tl)

    # ------------------------------------------------------------------
    def train(self, train_loader, val_loader, state: TrainState) -> TrainState:
        cfg = self.cfg
        best_recall = -1.0

        def report(epoch, res):
            print(f"Evaluation: Epoch {epoch}: SM Loss {res['sm_loss']:.2f} "
                  f"Class Loss {res['class_loss']:.2f} Trans Loss {res['trans_loss']:.2f} "
                  f"Recall {res['reg_recall']:.2f}")

        report(0, self.evaluate(val_loader, state))
        for epoch in range(cfg.max_epoch):
            state = self.train_epoch(train_loader, state, epoch + 1)
            if (epoch + 1) % cfg.evaluate_interval == 0 or epoch == 0:
                res = self.evaluate(val_loader, state)
                report(epoch + 1, res)
                if self.logger:
                    self.logger.log_dict("Val", res, epoch + 1)
                if res["reg_recall"] > best_recall:
                    best_recall = res["reg_recall"]
                    self.save_checkpoint(state, "best")
            if (epoch + 1) % cfg.snapshot_interval == 0:
                self.save_checkpoint(state, epoch + 1)
        return state

    # ------------------------------------------------------------------
    def train_epoch(self, loader, state: TrainState, epoch: int) -> TrainState:
        cfg = self.cfg
        meters = {k: AverageMeter() for k in (
            "loss", "class_loss", "sm_loss", "trans_loss", "reg_recall",
            "re", "te", "precision", "recall", "f1", "grad_finite")}
        data_timer, model_timer = Timer(), Timer()
        it = iter(loader)
        num_iter = min(cfg.training_max_iter, len(loader))
        # Metrics stay on the device between log points; the window is read
        # back in one copy at the logging cadence.
        pending: list[dict] = []

        def drain():
            if not pending:
                return
            keys = list(meters)
            table = torch.stack([torch.stack([md[k].float() for k in keys])
                                 for md in pending]).cpu().numpy()
            for row in table:
                md = dict(zip(keys, row))
                if np.isfinite(md["loss"]):
                    for k, m in meters.items():
                        if np.isfinite(md[k]):
                            m.update(float(md[k]))
            pending.clear()

        for i in range(num_iter):
            data_timer.tic()
            batch = self.to_device(next(it))
            data_timer.toc()

            model_timer.tic()
            state, metrics = self.train_step(state, batch, epoch)
            pending.append(metrics)
            log_now = (i + 1) % LOG_EVERY == 0 or (i + 1) == num_iter
            if log_now:
                drain()  # waits until the device has caught up
            model_timer.toc()

            if log_now and cfg.verbose:
                if self.logger:
                    self.logger.log_dict("Train", {k: m.avg for k, m in meters.items()},
                                         (epoch - 1) * num_iter + i)
                print(f"Epoch: {epoch} [{i + 1:4d}/{num_iter}] "
                      f"sm_loss: {meters['sm_loss'].avg:.2f} "
                      f"class_loss: {meters['class_loss'].avg:.2f} "
                      f"reg_recall: {meters['reg_recall'].avg:.2f}% "
                      f"re: {meters['re'].avg:.2f}deg te: {meters['te'].avg:.2f}cm "
                      f"data: {data_timer.avg:.3f}s model: {model_timer.avg:.3f}s")
        state.model.eval()
        return state

    # ------------------------------------------------------------------
    def evaluate(self, loader, state: TrainState) -> dict:
        """Mean of every finite metric over ``min(val_max_iter, len(loader))``
        batches."""
        it = iter(loader)
        num_iter = min(self.cfg.val_max_iter, len(loader))
        pending = [self.eval_step(state, self.to_device(next(it))) for _ in range(num_iter)]
        if not pending:
            return {}
        keys = list(pending[0])
        table = torch.stack([torch.stack([md[k].float() for k in keys])
                             for md in pending]).cpu().numpy()
        meters: dict[str, AverageMeter] = {}
        for row in table:
            for k, v in zip(keys, row):
                if np.isfinite(v):
                    meters.setdefault(k, AverageMeter()).update(float(v))
        return {k: m.avg for k, m in meters.items()}

    # ------------------------------------------------------------------
    def save_checkpoint(self, state: TrainState, tag) -> str:
        """``<save_dir>/model_<tag>.pkl``: msgpack in the JAX package's
        layout (``params``, ``batch_stats``, ``step``), which its
        ``load_model_weights`` and this package's ``load_pretrained`` read,
        plus this Trainer's optimizer and schedule under ``torch_optimizer``."""
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        path = os.path.join(self.cfg.save_dir, f"model_{tag}.pkl")
        payload = to_flax_variables(state.model.state_dict())
        payload["step"] = np.asarray(state.step, np.int32)
        payload["torch_optimizer"] = _pack_tree(
            {"optimizer": state.optimizer.state_dict(), "scheduler": state.scheduler.state_dict()})
        with open(path, "wb") as f:
            f.write(flax_msgpack.dumps(payload))
        if self.cfg.verbose:
            print(f"Save model to {path}")
        return path

    def load_checkpoint(self, path: str, state: TrainState) -> TrainState:
        """Weights, BatchNorm statistics and step of a checkpoint of either
        package; optimizer and schedule too when this Trainer wrote it (a JAX
        checkpoint's optax state has no counterpart: they then start anew)."""
        raw = flax_msgpack.load(path)
        state.model.load_state_dict(from_flax_variables(
            {"params": raw["params"], "batch_stats": raw.get("batch_stats", {})}), strict=True)
        saved = raw.get("torch_optimizer")
        if saved is not None:
            saved = _unpack_tree(saved)
            state.optimizer.load_state_dict(saved["optimizer"])
            state.scheduler.load_state_dict(saved["scheduler"])
        print(f"Load model from {path}")
        return state._replace(step=int(raw.get("step", 0)))


def _pack_tree(obj):
    """An optimizer/scheduler state dict as msgpack-able data: tensors become
    numpy arrays, integer keys ``"#<n>"`` strings; callables (the schedule's
    lambda) are dropped, as ``LambdaLR.state_dict`` already leaves them None."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {(f"#{k}" if isinstance(k, int) else k): _pack_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack_tree(v) for v in obj]
    return obj


def _unpack_tree(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj))
    if isinstance(obj, dict):
        return {(int(k[1:]) if k.startswith("#") else k): _unpack_tree(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack_tree(v) for v in obj]
    return obj


def load_model_weights(model: PointDSC, checkpoint_path: str) -> PointDSC:
    """Eval-side loader: the ``params`` and ``batch_stats`` of a snapshot of
    either package into ``model``, which comes back in eval mode."""
    raw = flax_msgpack.load(checkpoint_path)
    model.load_state_dict(from_flax_variables(
        {"params": raw["params"], "batch_stats": raw.get("batch_stats", {})}), strict=True)
    return model.eval()
