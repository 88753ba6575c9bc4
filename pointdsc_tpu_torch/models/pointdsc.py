"""PointDSC in PyTorch (counterpart of ``pointdsc_tpu/models/pointdsc.py``).

JAX's static flags map so: ``train`` is ``module.training``; ``testing``,
``fused`` (``fused_attention``) and ``skip_M`` stay arguments. Grad mode is
the caller's: ``register``, the ``Evaluator`` and the regime probe run under
``torch.no_grad()``, the Trainer's train step does not.

Two paths give the same result within the JAX suite's fused-vs-dense bound:

* ``fused=False`` (dense): the [B, N, N] compat matrix and the src distance
  matrix are materialised; attention, NMS and hypothesis scoring are plain
  PyTorch. This is the oracle of the fused path.
* ``fused=True`` (JAX ``fused_attention=True``): the compat matrix exists
  only as the int8 cache, and the cache build, confidence head, NMS flags,
  seed k-NN, scoring and post-refinement are CUDA kernels on a CUDA input
  (their plain versions on a CPU input). The encoder takes one of three
  forms, chosen by the constructor's flags as in JAX
  (``pointdsc_tpu/models/pointdsc.py:126-180``):

  - ``offset_softmax=True, half_precision=False`` (the default): each
    encoder layer is one whole-layer kernel up to N = 6144 and a pair of
    kernels above it (kernels/encoder_layer.py), BatchNorms folded;
  - ``offset_softmax=True, half_precision=True``: the encoder runs op by op
    with bf16 Dense products and the offset attention kernel;
  - ``offset_softmax=False``: op by op in f32 with the running-max attention
    kernel, exact for any weights. ``models/regime.py`` selects it for a
    checkpoint outside the offset softmax's validity regime.

  In training mode no cache is built and no whole-layer kernel runs (BN
  folding needs running statistics): each layer's attention is
  ``sc_attention_trainable``, whose forward and backward kernels recompute
  the compat tile from the geometry, so gradients reach q, k, v and nothing
  [B, N, N] is kept for the backward pass. ``fused_cache_compat=False``
  runs the eval forward through the same forward kernel, without a cache.

With ``testing=False`` (the Trainer's train and eval steps) the confidence
head is plain PyTorch, seeds are the top-k confidences, there is no
post-refinement, ``final_labels`` are the confidence logits, and ``M`` is the
feature-similarity matrix unless ``skip_M`` (the fused SM loss then works from
``normed_features`` and ``sigma``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.kernels.conf_mlp import confidence_head, confidence_head_plain
from pointdsc_tpu_torch.kernels.encoder_layer import make_fused_layer_fn
from pointdsc_tpu_torch.kernels.nms import pick_seeds_nms_prefiltered
from pointdsc_tpu_torch.kernels.refine import fused_post_refinement
from pointdsc_tpu_torch.kernels.sc_attention import (
    build_compat_cache_int8,
    fused_sc_attention,
    fused_sc_attention_cached,
    pack_geometry,
    sc_attention_trainable,
)
from pointdsc_tpu_torch.kernels.scoring import seed_inlier_counts
from pointdsc_tpu_torch.kernels.seed_knn import knn_bias, seed_knn_exact, seed_knn_plain
from pointdsc_tpu_torch.models.blocks import NonLocalNet
from pointdsc_tpu_torch.ops.compatibility import feature_similarity, spatial_consistency
from pointdsc_tpu_torch.ops.eig import power_iteration
from pointdsc_tpu_torch.ops.nms import pick_seeds_nms, pick_seeds_topk
from pointdsc_tpu_torch.ops.procrustes import weighted_procrustes
from pointdsc_tpu_torch.ops.se3 import transform


class PointDSCOutput(NamedTuple):
    final_trans: torch.Tensor  # [B, 4, 4]
    # [B, N]: 0/1 labels of the pre-refinement winner (testing), else the logits
    final_labels: torch.Tensor
    seed_trans: torch.Tensor  # [B, S, 4, 4]
    seed_fitness: torch.Tensor  # [B, S]
    confidence: torch.Tensor  # [B, N] classification logits
    normed_features: torch.Tensor  # [B, N, C] L2-normalised encoder output
    seeds: torch.Tensor  # [B, S] seed indices
    M: torch.Tensor | None = None  # [B, N, N] feature similarity (not testing, not skip_M)
    sigma: torch.Tensor | None = None  # the learned similarity bandwidth, (1,)


class PointDSC(nn.Module):
    """Spatial-consistency outlier rejection + SE(3) estimation network.
    Random weights come from ``generator`` (a torch.Generator); trained ones
    from compat/weights.py or ``load_pretrained``. A new model is in eval
    mode; the Trainer switches modes explicitly."""

    def __init__(self, in_dim: int = 6, num_layers: int = 12, num_channels: int = 128,
                 num_iterations: int = 10, ratio: float = 0.1,
                 inlier_threshold: float = 0.10, sigma_d: float = 0.10, k: int = 40,
                 nms_radius: float = 0.10, refine_iters: int = 20,
                 offset_softmax: bool = True, half_precision: bool = False,
                 remat: bool = False, fused_cache_compat: bool = True,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_iterations = num_iterations
        self.ratio = ratio
        self.inlier_threshold = inlier_threshold
        self.sigma_d = sigma_d
        self.k = k
        self.nms_radius = nms_radius
        self.refine_iters = refine_iters
        self.offset_softmax = offset_softmax
        self.half_precision = half_precision
        self.remat = remat  # checkpoint each encoder layer (training memory)
        self.fused_cache_compat = fused_cache_compat
        # folded BatchNorms of the whole-layer kernels, reused across forwards
        # (kernels/encoder_layer.py::folded_weights says what invalidates it)
        self._fold_cache: dict = {}
        self.sigma = nn.Parameter(torch.ones(1))
        self.encoder = NonLocalNet(in_dim, num_layers, num_channels)
        self.classification_0 = nn.Linear(num_channels, 32)
        self.classification_1 = nn.Linear(32, 32)
        self.classification_2 = nn.Linear(32, 1)
        if generator is not None:
            self._init_random(generator)
        self.to(dev).eval()

    @torch.no_grad()
    def _init_random(self, generator: torch.Generator) -> None:
        """Xavier-normal kernels and zero biases (the flax initialisers),
        drawn from the caller's generator."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                std = (2.0 / (fan_in + fan_out)) ** 0.5
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
                mod.bias.zero_()

    @full_f32_matmul()
    def forward(self, corr_pos, src_keypts, tgt_keypts, mask=None, testing: bool = True,
                fused: bool = True, skip_M: bool = False) -> PointDSCOutput:
        """corr_pos [B, N, in_dim], src/tgt [B, N, 3], mask [B, N] bool."""
        train = self.training
        corr_pos = corr_pos.float().contiguous()
        src_keypts = src_keypts.detach().float().contiguous()  # geometry has no gradient
        tgt_keypts = tgt_keypts.detach().float().contiguous()
        bs, num_corr = corr_pos.shape[:2]
        mask_arg = mask
        if mask is None:
            mask = torch.ones((bs, num_corr), dtype=torch.bool, device=corr_pos.device)

        # ---- Step 1: spatial consistency, shared by all attention layers
        attention_fn, fused_layer_fn = None, None
        compat, src_dist = None, None
        if fused and not train and self.fused_cache_compat:
            cache = build_compat_cache_int8(src_keypts, tgt_keypts, self.sigma_d, mask=mask_arg)
            offset = self.offset_softmax

            def attention_fn(q, k, v, _mask):
                return fused_sc_attention_cached(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), cache, src_keypts,
                                                 tgt_keypts, mask=mask_arg,
                                                 offset_softmax=offset)

            # the whole-layer kernels implement only the offset softmax in
            # f32 activations; the other configurations keep the encoder op
            # by op around the attention kernel
            if offset and not self.half_precision and not self.remat:
                fused_layer_fn = make_fused_layer_fn(cache, mask=mask_arg,
                                                     fold_cache=self._fold_cache)
        elif fused and train:
            geom = pack_geometry(src_keypts, tgt_keypts, mask_arg)
            sigma_d = self.sigma_d

            def attention_fn(q, k, v, _mask):
                return sc_attention_trainable(q.float(), k.float(), v.float(), geom, sigma_d)
        elif fused:
            sigma_d = self.sigma_d

            def attention_fn(q, k, v, _mask):
                return fused_sc_attention(q, k, v, src_keypts, tgt_keypts, sigma_d,
                                          mask=mask_arg)
        else:
            compat, src_dist = spatial_consistency(src_keypts, tgt_keypts, self.sigma_d,
                                                   mask=mask)

        corr_features = self.encoder(
            corr_pos, compat, mask=mask, attention_fn=attention_fn,
            fused_layer_fn=fused_layer_fn,
            compute_dtype=torch.bfloat16 if self.half_precision else None,
            remat=self.remat)
        feat_sq = torch.sum(corr_features * corr_features, dim=-1, keepdim=True)
        normed_features = corr_features / torch.sqrt(feat_sq + 1e-12)
        # a half-precision encoder hands on bf16; everything after it is f32
        corr_features, normed_features = corr_features.float(), normed_features.float()

        # ---- feature-similarity matrix, the dense SM loss's input
        M = None
        if not (testing or skip_M):
            M = feature_similarity(normed_features, self.sigma, mask=mask)

        # ---- Step 2: confidence head + seeds
        head = [t for layer in (self.classification_0, self.classification_1,
                                self.classification_2) for t in (layer.weight, layer.bias)]
        if fused and testing:
            confidence = confidence_head(corr_features, *head)
        else:
            confidence = confidence_head_plain(corr_features, *head)

        num_seeds = max(1, int(num_corr * self.ratio))
        if not testing:
            seeds = pick_seeds_topk(confidence.detach(), num_seeds, mask=mask)
        elif fused:
            seeds = pick_seeds_nms_prefiltered(src_keypts, confidence, self.nms_radius,
                                               num_seeds, mask=mask)
        else:
            seeds = pick_seeds_nms(src_dist, confidence, self.nms_radius, num_seeds, mask=mask)

        # ---- Steps 3-4: NSM per seed -> weighted Procrustes -> best hypothesis
        seed_trans, seed_fitness, final_trans, final_labels = self._seed_transforms(
            seeds, normed_features, src_keypts, tgt_keypts, mask, fused)

        if testing:
            # ---- Step 5: post refinement; the labels stay those of the
            # pre-refinement winner, as in the reference (PointDSC.py:182-193)
            final_trans = self.post_refinement(final_trans, src_keypts, tgt_keypts, mask, fused)
        else:
            final_labels = confidence  # the classification loss's logits
        return PointDSCOutput(final_trans, final_labels, seed_trans, seed_fitness,
                              confidence, normed_features, seeds, M, self.sigma)

    def _seed_transforms(self, seeds, feats, src_keypts, tgt_keypts, mask, fused):
        bs, num_corr, c = feats.shape
        k = min(self.k, num_corr - 1)
        if fused:
            knn_idx = seed_knn_exact(feats.detach(), seeds, k, mask=mask)  # [B, S, k]
        else:
            knn_idx = seed_knn_plain(feats.detach(), seeds, k, knn_bias(mask, feats))

        bundle = torch.cat([feats, src_keypts, tgt_keypts, mask.to(feats.dtype)[..., None]],
                           dim=-1)  # [B, N, C+7]
        flat = knn_idx.reshape(bs, -1)
        g = torch.gather(bundle, 1, flat[..., None].expand(-1, -1, c + 7)).reshape(
            bs, -1, k, c + 7)
        knn_features = g[..., :c]
        src_knn = g[..., c:c + 3]
        tgt_knn = g[..., c + 3:c + 6]
        knn_mask = g[..., c + 6] > 0.5
        seed_valid = torch.gather(mask, 1, seeds)

        sigma = self.sigma
        feat_M = torch.einsum("bskc,bsjc->bskj", knn_features, knn_features)
        feat_M = torch.clamp(1.0 - (1.0 - feat_M) / (sigma * sigma), min=0.0)

        def pdist(x):
            diff = x[..., :, None, :] - x[..., None, :, :]
            return torch.sqrt(torch.sum(diff * diff, dim=-1))

        spat_diff = pdist(src_knn) - pdist(tgt_knn)
        spat_M = torch.clamp(1.0 - spat_diff ** 2 / (self.sigma_d ** 2), min=0.0)
        total_M = feat_M * spat_M
        total_M = total_M * (1.0 - torch.eye(k, dtype=total_M.dtype, device=total_M.device))
        pair_mask = knn_mask[..., :, None] & knn_mask[..., None, :]
        total_M = torch.where(pair_mask, total_M, torch.zeros_like(total_M))

        weights = power_iteration(total_M, self.num_iterations)
        weights = torch.abs(weights) * knn_mask
        weights = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-6)
        seed_trans = weighted_procrustes(src_knn, tgt_knn, weights)  # [B, S, 4, 4]

        denom = torch.clamp(torch.sum(mask, dim=-1), min=1)[:, None]
        if fused:
            # hypothesis selection is an argmax: no gradient passes the counts
            counts = seed_inlier_counts(seed_trans.detach().contiguous(), src_keypts,
                                        tgt_keypts, self.inlier_threshold, mask=mask)
            seed_fitness = counts / denom
        else:
            pred = torch.einsum("bsij,bnj->bsni", seed_trans[:, :, :3, :3], src_keypts) \
                + seed_trans[:, :, None, :3, 3]
            L2_dis = torch.linalg.norm(pred - tgt_keypts[:, None], dim=-1)  # [B, S, N]
            inlier = (L2_dis < self.inlier_threshold) & mask[:, None, :]
            seed_fitness = torch.sum(inlier, dim=-1) / denom
        seed_fitness = torch.where(seed_valid, seed_fitness, torch.full_like(seed_fitness, -1.0))
        best = torch.argmax(seed_fitness, dim=-1)  # [B]
        final_trans = seed_trans[torch.arange(bs, device=best.device), best]
        if fused:
            best_dis = torch.linalg.norm(transform(src_keypts, final_trans) - tgt_keypts, dim=-1)
        else:
            best_dis = L2_dis[torch.arange(bs, device=best.device), best]
        final_labels = ((best_dis < self.inlier_threshold) & mask).float()
        return seed_trans, seed_fitness, final_trans, final_labels

    def post_refinement(self, initial_trans, src_keypts, tgt_keypts, mask, fused=False):
        """Up to ``refine_iters`` rounds of {warp, inliers, Geman-McClure
        re-fit}; a sample freezes once its inlier count stops changing. The
        fused path runs the rounds in one kernel on centred clouds
        (kernels/refine.py). Here all rounds run (a frozen sample stays
        frozen), which gives the early-exit loop's result without a device
        sync per round."""
        # the reference uses 1.2 for KITTI-config models (threshold != 0.10)
        thr = 0.10 if self.inlier_threshold == 0.10 else 1.2
        if fused and self.refine_iters > 0:
            return fused_post_refinement(initial_trans.contiguous(), src_keypts, tgt_keypts,
                                         mask, thr, self.refine_iters)
        bs = initial_trans.shape[0]
        trans = initial_trans
        prev_num = torch.zeros((bs,), dtype=torch.int64, device=trans.device)
        active = torch.ones((bs,), dtype=torch.bool, device=trans.device)
        for _ in range(self.refine_iters):
            dist = torch.linalg.norm(transform(src_keypts, trans) - tgt_keypts, dim=-1)
            inlier = (dist < thr) & mask
            num = torch.sum(inlier, dim=-1)
            changed = torch.abs(num - prev_num) >= 1
            w = inlier.to(dist.dtype) / (1.0 + (dist / thr) ** 2)
            new_trans = weighted_procrustes(src_keypts, tgt_keypts, w)
            active = active & changed
            trans = torch.where(active[:, None, None], new_trans, trans)
            prev_num = num
        return trans
