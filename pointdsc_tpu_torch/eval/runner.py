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
With ``solver="RANSAC"`` the transform is re-solved by the RANSAC baseline
(baselines/classical.py) on the inliers the model labelled, and with
``use_icp`` it is then polished by point-to-point ICP on the correspondence
keypoint clouds (ops/icp.py, the nearest-neighbour kernel once per iteration
for the whole batch); both inside ``model_time``, as they are inside the JAX
package's jitted forward.

With ``sp_mesh`` (a list of devices, parallel/mesh.py) every pair's encoder
runs row-sharded over the mesh (parallel/seq_parallel.py), and
``run_dataset_sharded`` fans the pairs out over a mesh, a batch of
``len(mesh)`` pairs at a time, one model replica on each distinct device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pointdsc_tpu_torch._device import resolve_device
from pointdsc_tpu_torch.baselines.classical import ransac_registration
from pointdsc_tpu_torch.data.pipeline import pad_to_bucket
from pointdsc_tpu_torch.eval.protocol import aggregate_stats, pair_stats
from pointdsc_tpu_torch.models.pointdsc import PointDSC
from pointdsc_tpu_torch.models.regime import select_attention_kernels
from pointdsc_tpu_torch.ops.icp import icp_point_to_point
from pointdsc_tpu_torch.parallel.mesh import canonical, make_mesh, shard_batch
from pointdsc_tpu_torch.parallel.seq_parallel import sp_encode, sp_encode_fused
from pointdsc_tpu_torch.utils.timer import Timer

_INPUTS = (("corr_pos", torch.float32), ("src_keypts", torch.float32),
           ("tgt_keypts", torch.float32), ("mask", torch.bool))


class Evaluator:
    def __init__(self, model: PointDSC, re_thre=15.0, te_thre=30.0, use_icp: bool = False,
                 icp_threshold: float = 0.10, fused_attention: bool = False,
                 solver: str = "SVD", sp_mesh=None, device: str | torch.device = "cuda"):
        """solver='SVD' uses the model's transform; solver='RANSAC' re-solves
        it by ``ransac_registration`` on the points the model labelled
        inliers (4096 hypotheses from a generator seeded 51 afresh on every
        forward, ``icp_threshold`` as the inlier threshold; the reference's
        test_3DMatch.py:59-77 runs Open3D's RANSAC there). ``use_icp`` then
        polishes the transform by ICP with ``icp_threshold`` as the
        correspondence distance. The model carries its weights and must live
        on ``device``.

        sp_mesh: a list of devices; every pair's encoder then runs
        sequence-parallel over it (row-sharded N^2 stage: ``sp_encode_fused``
        when ``fused_attention``, the dense-semantics ``sp_encode``
        otherwise), for pairs whose correspondence count outgrows one card.
        Bucket sizes must divide len(sp_mesh) (they are multiples of 64, so
        any power-of-two count up to 64 does)."""
        if solver not in ("SVD", "RANSAC"):
            raise ValueError(f"unknown solver {solver!r}")
        self.device = resolve_device(device)
        self._sp_mesh = None if sp_mesh is None else make_mesh(devices=sp_mesh)
        self._replicas: dict = {}  # (id of the model, device) -> its copy there
        self.model = model
        self.re_thre = re_thre
        self.te_thre = te_thre
        self._fused_attention = fused_attention
        self._solver = solver
        self._use_icp = use_icp
        self._icp_threshold = icp_threshold
        # the bound's slack depends on the pair, so the guard probes the first
        # few pairs besides the first pair of every bucket
        self._regime_probes_left = 3
        self._warmed_buckets: set[int] = set()
        self.last_slack: float | None = None  # of the latest probe, in nats
        self.flipped = False

    @torch.no_grad()
    def _forward(self, corr_pos, src_keypts, tgt_keypts, mask, model=None):
        """(trans, labels) of a batch on one device, through ``model`` (the
        Evaluator's own by default, with the sequence-parallel encoder when
        there is an ``sp_mesh``; a sharded run's replica, without it, as in
        JAX)."""
        features = None
        if model is None and self._sp_mesh is not None:
            encode = sp_encode_fused if self._fused_attention else sp_encode
            features = encode(self.model, corr_pos, src_keypts, tgt_keypts, self._sp_mesh,
                              mask=mask)
        model = self.model if model is None else model
        out = model(corr_pos, src_keypts, tgt_keypts, mask=mask, testing=True,
                    fused=self._fused_attention, precomputed_features=features)
        trans = out.final_trans
        if self._solver == "RANSAC":
            trans, _ = ransac_registration(
                src_keypts, tgt_keypts, torch.Generator().manual_seed(51),
                inlier_threshold=self._icp_threshold, num_hypotheses=4096,
                mask=(out.final_labels > 0) & mask)
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
        args = tuple(torch.as_tensor(padded[key])[None].to(device=self.device, dtype=dtype)
                     for key, dtype in _INPUTS)

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
        """Fan independent pairs over a mesh (a list of devices; by default
        every visible card, or the Evaluator's CPU): pairs are grouped by
        shape bucket into batches of ``len(mesh)`` (a short last batch padded
        with a repeat), each mesh entry takes one pair of a batch, and one
        model replica on each distinct device runs its entries' pairs as one
        batch; the devices run at once. The regime guard probes the whole
        batch, as it probes a pair in ``run_pair``, and a bucket's first batch
        runs once unrecorded. Column 9 is the batch's wall time over its real
        pairs (``model_time_semantics`` in the report says so)."""
        if mesh is None:
            mesh = make_mesh() if self.device.type == "cuda" else [self.device]
        mesh = make_mesh(devices=mesh)
        n_dev = len(mesh)
        rows = [None] * len(dataset)
        warmed: set[int] = set()
        pending: dict[int, list[tuple[int, dict, float]]] = {}

        def flush(bucket, items):
            n_real = len(items)
            while len(items) < n_dev:  # pad the batch with a repeat
                items.append(items[-1])
            batch = {key: np.stack([it[1][key] for it in items]) for key, _ in _INPUTS}
            # the whole batch on the Evaluator's device for the guard's probe
            args = tuple(torch.as_tensor(batch[key]).to(device=self.device, dtype=dtype)
                         for key, dtype in _INPUTS)
            if self._regime_probes_left > 0 or bucket not in warmed:
                if self._guard_offset_regime(args):
                    warmed.clear()
            if bucket not in warmed:
                self._forward_sharded(batch, mesh)  # discarded warm-up
                warmed.add(bucket)
            for dev in set(mesh):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            t = Timer()
            t.tic()
            trans, labels = self._forward_sharded(batch, mesh)  # read back: synchronised
            # col 9 (reference test_3DMatch.py:99-100) is a pair's model time:
            # the batch evaluates n_real pairs at once, so each gets wall /
            # n_real (the padding repeats are charged to the real pairs)
            model_time = t.toc(average=False) / n_real
            for slot, (idx, padded, data_time) in enumerate(items[:n_dev]):
                if rows[idx] is not None:
                    continue
                n = int(padded["mask"].sum())
                rows[idx] = pair_stats(trans[slot], labels[slot][:n], padded["gt_trans"],
                                       padded["gt_labels"][:n], self.re_thre, self.te_thre,
                                       model_time, data_time, scene_of(idx) if scene_of else 0)

        data_timer = Timer()
        for i in range(len(dataset)):
            data_timer.tic()
            sample = pad_to_bucket(dataset[i])
            data_time = data_timer.toc(average=False)
            bucket = sample["corr_pos"].shape[0]
            pending.setdefault(bucket, []).append((i, sample, data_time))
            if len(pending[bucket]) == n_dev:
                flush(bucket, pending.pop(bucket))
            if verbose and (i + 1) % 100 == 0:
                print(f"[{i + 1}/{len(dataset)}] pairs loaded")
        for bucket, items in pending.items():
            flush(bucket, items)

        stats = np.stack([r for r in rows if r is not None], axis=0)
        agg = aggregate_stats(stats)
        # pairs run at once on different devices, so a pair's own device
        # latency is not defined here: the column is a throughput share
        agg["model_time_semantics"] = (
            f"batch-amortized: wall/n over {n_dev}-pair sharded dispatches")
        return stats, agg

    def _replica(self, dev: torch.device):
        """The model on ``dev``: the Evaluator's own on its device, else a
        copy made once per device (and again after a regime flip)."""
        if dev == canonical(self.device):
            return self.model
        key = (id(self.model), dev)
        if key not in self._replicas:
            self._replicas.clear()
            self._replicas[key] = copy.deepcopy(self.model).to(dev)
        return self._replicas[key]

    def _forward_sharded(self, batch: dict, mesh):
        """One batch of len(mesh) pairs (numpy arrays [len(mesh), ...]):
        mesh entry i takes pair i; the entries of one device run as one
        batch through that device's replica, every device's batch queued
        before any is read back. Returns (trans [D, 4, 4], labels [D, N]) as
        numpy arrays."""
        shards = shard_batch({key: batch[key] for key, _ in _INPUTS}, mesh)
        slots: dict[torch.device, list[int]] = {}
        for i, dev in enumerate(mesh):
            slots.setdefault(dev, []).append(i)
        outs = {}
        for dev, idx in slots.items():
            args = tuple(torch.cat([shards[i][key] for i in idx]).to(dtype)
                         for key, dtype in _INPUTS)
            outs[dev] = self._forward(*args, model=self._replica(dev))
        trans = np.zeros((len(mesh), 4, 4), np.float32)
        labels = np.zeros((len(mesh), batch["mask"].shape[1]), np.float32)
        for dev, idx in slots.items():
            trans[idx] = outs[dev][0].cpu().numpy()
            labels[idx] = outs[dev][1].float().cpu().numpy()
        return trans, labels
