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
  seed k-NN, the seed hypotheses with their scoring and selection, and the
  post-refinement are CUDA kernels on a CUDA input (their plain versions on
  a CPU input); the confidence head and the seed k-NN only inside the JAX
  model's gates (``use_confidence_kernel``, ``use_seed_knn_kernel``), plain
  math outside them; the seed hypotheses only where no gradient is asked for
  (``use_hypothesis_kernel``). The kernels work in chunks of 128 channels
  and zero-pad a model to the next multiple of 128, so every C runs fused on
  the card, and so does every k (the hypotheses kernel gives a thread
  several neighbour rows). The encoder takes one of three
  forms, chosen by the constructor's flags as in JAX
  (``pointdsc_tpu/models/pointdsc.py:126-180``):

  - ``offset_softmax=True, half_precision=False`` (the default): each
    encoder layer is one whole-layer kernel up to N = 6144 and a pair of
    kernels above it (kernels/encoder_layer.py), BatchNorms folded;
  - ``offset_softmax=True, half_precision=True``: the encoder runs op by op
    with bf16 Dense products and the offset attention kernel;
  - ``offset_softmax=False``: op by op in f32 with the running-max attention
    kernel, exact for any weights; on the card the attention takes bf16 q,
    k, v and rounds p to bf16 before p v, on the CPU it stays f32, as in
    JAX. ``models/regime.py`` selects it for a checkpoint outside the
    offset softmax's validity regime.

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
from pointdsc_tpu_torch.kernels.conf_mlp import (
    confidence_head,
    confidence_head_plain,
    packed_head_weights,
)
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
from pointdsc_tpu_torch.kernels.scoring import (
    seed_hypotheses,
    seed_inlier_counts,
    seed_transforms_plain,
    select_hypothesis_plain,
)
from pointdsc_tpu_torch.kernels.seed_knn import seed_knn_exact
from pointdsc_tpu_torch.models.blocks import NonLocalNet
from pointdsc_tpu_torch.ops.compatibility import feature_similarity, spatial_consistency
from pointdsc_tpu_torch.ops.knn import seed_knn_sorted
from pointdsc_tpu_torch.ops.nms import pick_seeds_nms, pick_seeds_topk
from pointdsc_tpu_torch.ops.procrustes import weighted_procrustes
from pointdsc_tpu_torch.ops.se3 import transform

# The JAX model's gates of two kernels (pointdsc_tpu/models/pointdsc.py:242,
# :334), with its constant: outside them it runs plain math, and so does the
# port, on the card as on the CPU.
_SEED_KNN_FUSED_MIN_N = 4096


def use_confidence_kernel(fused: bool, testing: bool, num_channels: int) -> bool:
    """Whether the fused forward runs the confidence-head kernel."""
    return fused and testing and num_channels == 128


def use_seed_knn_kernel(fused: bool, num_corr: int, k: int) -> bool:
    """Whether the fused forward runs the exact seed k-NN kernel (k is the
    neighbour count after its clamp to N - 1)."""
    return fused and num_corr >= _SEED_KNN_FUSED_MIN_N and k <= 128


def use_hypothesis_kernel(fused: bool, testing: bool, needs_grad: bool) -> bool:
    """Whether the forward runs the seed stage after the seed k-NN as
    ``kernels/scoring.py::seed_hypotheses`` (three launches on the card, its
    plain version on the CPU): the fused eval forward where no gradient is
    asked for (grad mode off, or nothing that enters the stage requires one:
    the Evaluator, ``register`` and the regime probe run under
    ``torch.no_grad()``). The kernels carry no gradient, so training
    (``testing=False``), a forward under autograd and the dense path run the
    plain code: the JAX model has one path, differentiable everywhere. The
    hypotheses kernel takes any k."""
    return fused and testing and not needs_grad


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
    mode; the Trainer switches modes explicitly. ``approx_knn`` is accepted
    for the reference's signature and selects exactly either way: exact
    selection meets any recall target."""

    def __init__(self, in_dim: int = 6, num_layers: int = 12, num_channels: int = 128,
                 num_iterations: int = 10, ratio: float = 0.1,
                 inlier_threshold: float = 0.10, sigma_d: float = 0.10, k: int = 40,
                 nms_radius: float = 0.10, refine_iters: int = 20,
                 offset_softmax: bool = True, half_precision: bool = False,
                 remat: bool = False, fused_cache_compat: bool = True,
                 approx_knn: bool = False, device: str | torch.device = "cuda",
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
        self.num_channels = num_channels
        self.offset_softmax = offset_softmax
        self.half_precision = half_precision
        self.remat = remat  # checkpoint each encoder layer (training memory)
        self.fused_cache_compat = fused_cache_compat
        # the reference's approximate top-k of the seed k-NN (recall target
        # 0.95) has no counterpart on the card: both values take the exact
        # selection (the seed k-NN kernel inside its gate), which meets any
        # recall target, so the outputs do not depend on the flag
        self.approx_knn = approx_knn
        # folded BatchNorms of the whole-layer kernels and the confidence head's
        # packed weights, reused across forwards (kernels/encoder_layer.py::
        # folded_weights says what invalidates them)
        self._fold_cache: dict = {}
        self._head_cache: dict = {}
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
                fused: bool = True, skip_M: bool = False,
                precomputed_features: torch.Tensor | None = None) -> PointDSCOutput:
        """corr_pos [B, N, in_dim], src/tgt [B, N, 3], mask [B, N] bool.

        ``precomputed_features`` [B, N, C] stands in for the encoder's output
        (the sequence-parallel encoder of parallel/seq_parallel.py runs it
        row-sharded over a mesh): no compat matrix or cache is built and the
        seed NMS runs from the coordinates, as in JAX
        (``pointdsc_tpu/models/pointdsc.py:119-124,209-210``)."""
        train = self.training
        corr_pos = corr_pos.float().contiguous()
        src_keypts = src_keypts.detach().float().contiguous()  # geometry has no gradient
        tgt_keypts = tgt_keypts.detach().float().contiguous()
        bs, num_corr = corr_pos.shape[:2]
        num_seeds = max(1, int(num_corr * self.ratio))
        mask_arg = mask
        if mask is None:
            mask = torch.ones((bs, num_corr), dtype=torch.bool, device=corr_pos.device)

        # ---- Step 1: spatial consistency, shared by all attention layers
        attention_fn, fused_layer_fn = None, None
        compat, src_dist = None, None
        if precomputed_features is not None:
            pass  # the encoder ran outside: nothing [N, N] here, NMS from coordinates
        elif fused and not train and self.fused_cache_compat:
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

        if precomputed_features is not None:
            corr_features = precomputed_features
        else:
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
        if use_confidence_kernel(fused, testing, self.num_channels):
            confidence = confidence_head(corr_features,
                                         packed_head_weights(head, self._head_cache))
        else:
            confidence = confidence_head_plain(corr_features, *head)

        if not testing:
            seeds = pick_seeds_topk(confidence.detach(), num_seeds, mask=mask)
        elif src_dist is None:  # the fused path, or an encoder run outside
            seeds = pick_seeds_nms_prefiltered(src_keypts, confidence, self.nms_radius,
                                               num_seeds, mask=mask)
        else:
            seeds = pick_seeds_nms(src_dist, confidence, self.nms_radius, num_seeds, mask=mask)

        # ---- Steps 3-4: NSM per seed -> weighted Procrustes -> best hypothesis
        seed_trans, seed_fitness, final_trans, final_labels = self._seed_transforms(
            seeds, normed_features, src_keypts, tgt_keypts, mask, fused, testing)

        if testing:
            # ---- Step 5: post refinement; the labels stay those of the
            # pre-refinement winner, as in the reference (PointDSC.py:182-193)
            final_trans = self.post_refinement(final_trans, src_keypts, tgt_keypts, mask, fused)
        else:
            final_labels = confidence  # the classification loss's logits
        return PointDSCOutput(final_trans, final_labels, seed_trans, seed_fitness,
                              confidence, normed_features, seeds, M, self.sigma)

    def _seed_transforms(self, seeds, feats, src_keypts, tgt_keypts, mask, fused, testing):
        bs, num_corr, c = feats.shape
        k = min(self.k, num_corr - 1)
        if use_seed_knn_kernel(fused, num_corr, k):
            knn_idx = seed_knn_exact(feats.detach(), seeds, k, mask=mask)  # [B, S, k]
        else:
            knn_idx = seed_knn_sorted(feats.detach(), seeds, k, mask)

        sigma = self.sigma
        needs_grad = torch.is_grad_enabled() and (feats.requires_grad or sigma.requires_grad)
        if use_hypothesis_kernel(fused, testing, needs_grad):
            return seed_hypotheses(feats, seeds, knn_idx, src_keypts, tgt_keypts, mask, sigma,
                                   self.sigma_d, self.inlier_threshold, self.num_iterations)
        seed_trans = seed_transforms_plain(feats, knn_idx, src_keypts, tgt_keypts, mask, sigma,
                                           self.sigma_d, self.num_iterations)  # [B, S, 4, 4]
        if fused:
            # hypothesis selection is an argmax: no gradient passes the counts
            counts = seed_inlier_counts(seed_trans.detach().contiguous(), src_keypts,
                                        tgt_keypts, self.inlier_threshold, mask=mask)
            return (seed_trans, *select_hypothesis_plain(seed_trans, counts, seeds, src_keypts,
                                                         tgt_keypts, self.inlier_threshold, mask))
        denom = torch.clamp(torch.sum(mask, dim=-1), min=1)[:, None]
        pred = torch.einsum("bsij,bnj->bsni", seed_trans[:, :, :3, :3], src_keypts) \
            + seed_trans[:, :, None, :3, 3]
        L2_dis = torch.linalg.norm(pred - tgt_keypts[:, None], dim=-1)  # [B, S, N]
        inlier = (L2_dis < self.inlier_threshold) & mask[:, None, :]
        seed_fitness = torch.sum(inlier, dim=-1) / denom
        seed_valid = torch.gather(mask, 1, seeds)
        seed_fitness = torch.where(seed_valid, seed_fitness, torch.full_like(seed_fitness, -1.0))
        best = torch.argmax(seed_fitness, dim=-1)  # [B]
        final_trans = seed_trans[torch.arange(bs, device=best.device), best]
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
