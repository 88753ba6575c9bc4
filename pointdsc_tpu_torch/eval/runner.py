"""Pair-wise evaluation loop (counterpart of ``pointdsc_tpu/eval/runner.py``).

Each pair is padded to a shape bucket and run through the testing-mode
forward. The first pair of a bucket runs once unrecorded, so that
``model_time`` never includes the kernels' build or a first-use allocation,
and ``model_time`` ends in a device synchronise, so it is execution time and
not the enqueue.

With ``fused_attention`` and a model that runs the offset softmax, the
Evaluator guards its validity regime (models/regime.py): it probes the first
three pairs and the first pair of every bucket, and switches to the
running-max kernel before any timed forward once a probe leaves the regime.
With ``use_icp`` the model's transform is polished by point-to-point ICP on
the correspondence keypoint clouds (ops/icp.py, the nearest-neighbour kernel
once per iteration for the whole batch), inside ``model_time`` as it is
inside the JAX package's jitted forward.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.data.pipeline import pad_to_bucket
from pointdsc_tpu_torch.eval.protocol import aggregate_stats, pair_stats
from pointdsc_tpu_torch.models.pointdsc import PointDSC
from pointdsc_tpu_torch.models.regime import select_attention_kernels
from pointdsc_tpu_torch.ops.icp import icp_point_to_point
from pointdsc_tpu_torch.utils.timer import Timer


class Evaluator:
    def __init__(self, model: PointDSC, re_thre=15.0, te_thre=30.0, use_icp: bool = False,
                 icp_threshold: float = 0.10, fused_attention: bool = False,
                 solver: str = "SVD", sp_mesh=None, device: str | torch.device = "cuda"):
        """solver='SVD' uses the model's transform; ``use_icp`` polishes it
        by ICP with ``icp_threshold`` as the correspondence distance. The
        model carries its weights and must live on ``device``. Not ported
        yet, and refused: solver='RANSAC' (needs baselines/classical.py),
        sp_mesh (parallel/seq_parallel.py)."""
        if solver == "RANSAC":
            raise NotImplementedError(
                "solver='RANSAC' needs baselines/classical.py::ransac_registration, "
                "which is not ported")
        if solver != "SVD":
            raise ValueError(f"unknown solver {solver!r}")
        if sp_mesh is not None:
            raise NotImplementedError(
                "sp_mesh needs parallel/seq_parallel.py (the sequence-parallel encoder), "
                "which is not ported")
        self.device = resolve_device(device)
        self.model = model
        self.re_thre = re_thre
        self.te_thre = te_thre
        self._fused_attention = fused_attention
        self._use_icp = use_icp
        self._icp_threshold = icp_threshold
        # the bound's slack depends on the pair, so the guard probes the first
        # few pairs besides the first pair of every bucket
        self._regime_probes_left = 3
        self._warmed_buckets: set[int] = set()
        self.last_slack: float | None = None  # of the latest probe, in nats
        self.flipped = False

    @torch.no_grad()
    def _forward(self, corr_pos, src_keypts, tgt_keypts, mask):
        out = self.model(corr_pos, src_keypts, tgt_keypts, mask=mask, testing=True,
                         fused=self._fused_attention)
        trans = out.final_trans
        if self._use_icp:
            # ICP polish on the correspondence keypoint clouds (reference
            # icp_refine, benchmark_utils.py:40-56), every batch row at once
            trans, _, _ = icp_point_to_point(src_keypts, tgt_keypts, trans,
                                             max_correspondence_distance=self._icp_threshold,
                                             src_mask=mask, tgt_mask=mask)
        return trans, out.final_labels

    def _guard_offset_regime(self, args) -> bool:
        """One probe of models/regime.py::select_attention_kernels on this
        pair; out of regime switches the model to the running-max kernel
        (exact for any weights) before any timed forward."""
        if not self._fused_attention or not self.model.offset_softmax:
            self._regime_probes_left = 0
            return False
        self._regime_probes_left = max(self._regime_probes_left - 1, 0)
        corr_pos, src, tgt, mask = args
        self.model, self.last_slack, flipped = select_attention_kernels(
            self.model, corr_pos, src, tgt, mask=mask, context="eval")
        if flipped:
            self.flipped = True
            self._regime_probes_left = 0  # the running-max kernel is exact
            # buckets were warmed through the other kernels
            self._warmed_buckets.clear()
        return flipped

    def run_pair(self, sample: dict, scene_ind: int = 0, data_time: float = 0.0):
        """sample: un-padded dict from a dataset; returns (12-column stats
        row, [4, 4] transform)."""
        n = sample["corr_pos"].shape[0]
        padded = pad_to_bucket(sample)
        args = tuple(
            torch.as_tensor(padded[key])[None].to(device=self.device, dtype=dtype)
            for key, dtype in (("corr_pos", torch.float32), ("src_keypts", torch.float32),
                               ("tgt_keypts", torch.float32), ("mask", torch.bool)))

        bucket = padded["corr_pos"].shape[0]
        if self._regime_probes_left > 0 or bucket not in self._warmed_buckets:
            self._guard_offset_regime(args)
        if bucket not in self._warmed_buckets:
            self._forward(*args)  # discarded warm-up
            self._warmed_buckets.add(bucket)

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = Timer()
        t.tic()
        trans, labels = self._forward(*args)
        model_time = t.toc(average=False, block_on=trans)
        trans = trans[0].cpu().numpy()
        labels = labels[0, :n].cpu().numpy()
        row = pair_stats(trans, labels, sample["gt_trans"], sample["gt_labels"], self.re_thre,
                         self.te_thre, model_time, data_time, scene_ind)
        return row, trans

    def run_dataset(self, dataset, scene_of=None, verbose=True):
        """Evaluate every pair; ``scene_of(i)`` maps index -> scene id.
        Returns ([pairs, 12] stats, aggregate dict)."""
        rows = []
        timer = Timer()
        for i in range(len(dataset)):
            timer.tic()
            sample = dataset[i]
            data_time = timer.toc(average=False)
            scene = scene_of(i) if scene_of else 0
            row, _ = self.run_pair(sample, scene_ind=scene, data_time=data_time)
            rows.append(row)
            if verbose and (i + 1) % 100 == 0:
                print(f"[{i + 1}/{len(dataset)}] pairs evaluated")
        stats = np.stack(rows, axis=0)
        return stats, aggregate_stats(stats)

    def run_dataset_sharded(self, dataset, mesh=None, scene_of=None, verbose=True):
        raise NotImplementedError(
            "run_dataset_sharded (pairs fanned over several cards) is not ported; "
            "use run_dataset")
