#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and the exit code is not 0):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels with nvcc (one process per source, in parallel);
  3. hold each kernel's public wrapper against its plain PyTorch version on
     the card at the main paths' shapes (N = 5120, C = 128, S = 512, the last
     5% of points padded; the split pair of encoder-layer kernels at
     N = 12288), and time both with CUDA events;
  4. load the Synthetic snapshot in the running-max configuration
     (``offset_softmax=False``) and run it through ``register`` (the fused
     path, which launches the kernels) with every launch count set
     to 0 just before and read just after: 3 synthetic pairs, and a 4th pair
     through a copy of the model whose logit bias is raised so that a share
     of the confidences is positive and NMS picks the seeds by score (the
     snapshot's logits are all negative on these pairs, so its seeds are the
     suppressed points in index order). Each result is held against the dense
     path (``fused=False``), and its seeds and seed fitness against the dense
     NMS and an [S, N] inlier count on the run's own confidences and seed
     transforms;
  5. hold the first 3 results against the JAX package's golden file;
  6. check that every kernel of that path was launched on it;
  7. time the fused forward (median of 10 after warm-up, CUDA events);
  8. the default configuration (offset softmax, whole-layer kernels) through
     ``Evaluator.run_dataset`` with the regime guard live, counts set to 0
     before each run and read after: 3 Synthetic pairs at N = 5120 (one
     kernel per layer) and 2 pairs at N = 12288 through the SyntheticKITTI
     snapshot (sigma_d 1.2; pairs of half-width 50 m, noise 0.05 m, inlier
     radius 0.6 m, the data that snapshot was trained on: the pair of kernels
     per layer, and the NMS top-M prefilter). The pairs are ones on which the
     snapshots stay inside the offset softmax's regime (the slack depends on
     the pair; tools/regime_scan.py). Each result is held against the dense
     path, the 5120 ones against a second golden file of the JAX dense path;
  9. one pair through ``half_precision=True`` (the per-op bf16 encoder around
     the offset attention kernel), against the f32 dense path;
 10. one pair through a copy whose key projections are scaled by 100: the
     guard must switch it to the running-max kernel;
 11. time the default forward at both sizes as in 7.
Then training (``train/trainer.py``), at the reference training shape: 12
layers, C = 128, k = 40, bs 16, 1000 correspondences padded to 1024:
 12. hold the five training kernels' public entries (attention forward with
     the row LSE, backward dQ, backward dK and dV, SM-loss sums, SM-loss
     gradients) and the eval attention without a cache against their plain
     versions at bs 16 / N = 1024 with 24 padded points, the attention trio
     also at one sample of N = 12288; time them;
 13. the eval forward with ``fused_cache_compat=False`` (the forward kernel of
     the trainable attention without the LSE store) against the dense path;
 14. one train step, fused against dense, from the same weights and batch:
     loss terms and every parameter's gradient, held to a tolerance at depth
     2 (full width) and printed at depth 12, where the train-mode forward is
     too ill-conditioned for two exact implementations to stay together;
 15. the ``Trainer`` on the synthetic loader, fused: two epochs of 12 steps
     (the same batches) through ``train_epoch``, ``evaluate`` and
     ``save_checkpoint`` with the counts set to 0 before and read after; the
     second epoch's mean loss must
     be finite and below the first's, every step's gradients finite;
 16. ms per step (median, host clock closed by a synchronise), peak memory
     and launches per step, fused and dense;
 17. two fused steps in the KITTI regime (N = 12288, bs 2, sigma_d 1.2) with
     their peak memory; the dense step is tried for its memory figure only,
     and an out-of-memory error is reported as a finding;
 18. the Trainer's checkpoint through ``load_pretrained`` and ``register``.
Prints a JSON line per kernel, one {"kernels": [...]} line, and as the last
line {"ok": true, "device": {...}}. Needs a CUDA card; exits non-zero
without one or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "snapshot", "PointDSC_Synthetic_release")
SNAPSHOT_KITTI = os.path.join(ROOT, "snapshot", "PointDSC_SyntheticKITTI_release")
GOLDEN = os.path.join(ROOT, "pointdsc_tpu_torch", "testdata", "golden_n5120.npz")
GOLDEN_DEFAULT = os.path.join(ROOT, "pointdsc_tpu_torch", "testdata", "golden_n5120_seed1.npz")
N, C, PAIRS = 5120, 128, 3
N_KITTI, PAIRS_KITTI = 12288, 2
# the data the SyntheticKITTI snapshot was trained on
KITTI_DATA = dict(scene_scale=50.0, noise=0.05, inlier_threshold=0.6)
# pairs on which the snapshots stay inside the offset softmax's regime
DEFAULT_DATA = dict(seed=1, inlier_ratio=0.4)        # Synthetic, N = 5120
DEFAULT_DATA_KITTI = dict(seed=0, inlier_ratio=0.2)  # SyntheticKITTI, N = 12288
S, K = N // 10, 40
PAD_FRACTION = 0.05
DEVICE = "cuda"

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core
# FLOP/s, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

# f32 operations per element of each kernel's work, counted from its source
OPS_PER_CACHE_ENTRY = 28  # two 3-dots (10), two gram distances (8), one-sqrt diff (5), scale+round (5)
OPS_PER_NMS_PAIR = 13  # 3-dot (5), gram distance (4), two compares and the AND (4)
OPS_PER_SCORING_PAIR = 29  # three 4-term rows (18), residual (3), squared norm (5), test+count (3)
OPS_PER_ATTN_PAIR_EXTRA = 8  # scale, compat multiply, bias add, max, exp, sum per (q, k)
OPS_PER_CONF_ROW = 2 * (128 * 32 + 32 * 32 + 32) + 2 * 32 + 1  # three layers, biases, ReLUs
OPS_PER_KNN_PAIR = 2 * C + 1  # the 128-term dot product and one compare of the selection
OPS_PER_REFINE_POINT = 63  # warp (18), residual (5), test and weight (5), Gram terms (35)
OPS_PER_COMPAT_PAIR = 25  # two 3-dots (10), two gram distances (10), diff, square, divide, 1 -, max
OPS_PER_ATTN_BWD_PAIR_EXTRA = 9  # scale, compat multiply, bias, - lse, exp, dP - D, 3 multiplies
OPS_PER_SM_PAIR = 14  # u (3), clip and diagonal (3), pm and gtM (3), two squared terms (5)
OPS_PER_SM_BWD_PAIR = 24  # the forward's M terms (9), g (8), gate (4), dsigma term (3)

# the reference training shape and the KITTI regime of tools/train_synthetic.py
TRAIN_BS, TRAIN_NODE, TRAIN_N = 16, 1000, 1024
TRAIN_STEPS_PER_EPOCH = 12
KITTI_BS = 2


def check(ok, message: str) -> None:
    """Fail the phase (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median wall time of fn on the device, from CUDA events per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(bytes_moved: float, ops: float, tensor_ops: float = 0.0) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over their
    peak: ``ops`` at the f32 CUDA-core rate, ``tensor_ops`` (products with
    bf16 operands and f32 accumulation) at the dense bf16 tensor-core rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_FLOP_PER_S + tensor_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(torch, dev):
    """Inputs at the main path's shapes: one synthetic pair's geometry, the
    last 5% of points padded, features/scores/weights from a seeded
    generator and seed transforms near the pair's ground truth."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset

    ex = SyntheticPairDataset(num_pairs=1, num_corr=N, inlier_ratio=0.4, seed=1)[0]
    gen = torch.Generator().manual_seed(0)
    src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
    tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
    mask = (torch.arange(N) < N - int(N * PAD_FRACTION))[None].to(dev)
    qkv = [torch.randn((1, N, C), generator=gen).to(dev) for _ in range(3)]
    scores = torch.randn((1, N), generator=gen).to(dev)
    gt = torch.as_tensor(ex["gt_trans"]).to(dev)
    trans = gt.expand(1, S, 4, 4).clone()
    trans[:, :, :3, 3] += 0.05 * torch.randn((1, S, 3), generator=gen).to(dev)
    head = [(torch.randn(shape, generator=gen) * 0.2).to(dev)
            for shape in ((32, C), (32,), (32, 32), (32,), (1, 32), (1,))]
    seeds = torch.randperm(N, generator=gen)[None, :S].to(dev)
    init = gt[None].clone()
    init[:, :3, 3] += 0.03
    return dict(src=src, tgt=tgt, mask=mask, qkv=qkv, scores=scores, trans=trans, head=head,
                seeds=seeds, init=init)


def layer_inputs(torch, dev, n, sigma_d, **data):
    """One encoder layer's inputs at N = n, C = 128: a synthetic pair's cache
    (the last 5% of points padded), activations and weights from a seeded
    generator. The q and k projections are scaled so that the logits have a
    standard deviation of ~3 and the offsets sit near 40 nats: a sharp
    softmax inside the regime, where a wrong p would show."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset
    from pointdsc_tpu_torch.kernels import encoder_layer as kenc
    from pointdsc_tpu_torch.kernels import sc_attention as katt

    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, inlier_ratio=0.4, seed=1, **data)[0]
    src = torch.as_tensor(ex["src_keypts"])[None].to(dev)
    tgt = torch.as_tensor(ex["tgt_keypts"])[None].to(dev)
    mask = (torch.arange(n) < n - int(n * PAD_FRACTION))[None].to(dev)
    gen = torch.Generator().manual_seed(2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def bn(ch):
        return (1.0 + rnd(ch, scale=0.1), rnd(ch, scale=0.1), rnd(ch, scale=0.1),
                1.0 + rnd(ch, scale=0.1).abs())

    w, qk = C ** -0.5, (3.0 / 64.0) ** 0.5
    pcn = (rnd(C, C, scale=w), rnd(C, scale=0.1), bn(C))
    nl = (rnd(C, C, scale=qk), rnd(C, scale=0.1), rnd(C, C, scale=qk), rnd(C, scale=0.1),
          rnd(C, C, scale=w), rnd(C, scale=0.1), rnd(C // 2, C, scale=w), rnd(C // 2, scale=0.1),
          bn(C // 2), rnd(C // 2, C // 2, scale=w), rnd(C // 2, scale=0.1), bn(C // 2),
          rnd(C, C // 2, scale=w), rnd(C, scale=0.1))
    return dict(x=rnd(1, n, C), weights=kenc.fold_layer(pcn, nl), mask=mask,
                cache=katt.build_compat_cache_int8(src, tgt, sigma_d, mask=mask),
                kbias=katt.key_bias(mask, 1, n, dev))


def layer_counts(n):
    """(bytes, f32 operations, operations of the two N^2 C products) of one
    encoder layer's three parts at N = n: [PointCN + QKV, attention, MLP]."""
    act = n * C * 4
    w_a = (C * C + C + 3 * C * C + 3 * C) * 4
    w_b = (C * C // 2 + C // 2 + C * C // 4 + C // 2 + C * C // 2 + C) * 4
    ops_a = 2.0 * n * (C * C + 3 * C * C)
    ops_b = 2.0 * n * (C * C // 2 + C * C // 4 + C * C // 2)
    return dict(act=act, half=act // 2, w_a=w_a, w_b=w_b, ops_a=ops_a, ops_b=ops_b,
                cache=n * n + n * 4, attn=4.0 * n * n * C,
                attn_extra=float(OPS_PER_ATTN_PAIR_EXTRA) * n * n)


def knn_sets_agree(torch, idx, ref, sim, k) -> bool:
    """Per seed, the two index sets agree except for candidates whose
    similarity lies within 1e-5 of the k-th largest: a near tie that two
    summation orders of the same dot product may break either way."""
    kth = torch.gather(sim, -1, ref[..., k - 1:k])
    for got, other in ((idx, ref), (ref, idx)):
        missing = ~(got[..., :, None] == other[..., None, :]).any(-1)
        if bool((missing & ((torch.gather(sim, -1, got) - kth).abs() >= 1e-5)).any()):
            return False
    return True


def check_kernels(torch, dev) -> list[dict]:
    """Phase 3: every kernel's public wrapper against its plain version, on
    the card, on the same inputs.

    ``library_ms`` is null for all eleven: no single PyTorch call computes any
    of them (the attentions' compat factor multiplies the logits, which
    ``scaled_dot_product_attention``'s additive mask cannot express, and the
    encoder-layer kernels hold such an attention; the confidence head is
    three layers; the k-NN a product and a selection; the refinement a loop).

    ``bound_ms`` takes every operation at the peak of its operands' type.
    Three kernels hold the two N^2 C attention products on bf16 operands with
    f32 accumulation (the offset attention and the two layer kernels around
    it): those products count at the dense bf16 tensor-core peak, the rest at
    the f32 rate. They carry a second figure, ``bound_ms_f32_cores``, with
    everything at the f32 CUDA-core peak: the most that these first versions,
    which widen to f32 and use no tensor cores, could reach."""
    from pointdsc_tpu_torch.kernels import conf_mlp as kconf
    from pointdsc_tpu_torch.kernels import encoder_layer as kenc
    from pointdsc_tpu_torch.kernels import nms as knms
    from pointdsc_tpu_torch.kernels import refine as kref
    from pointdsc_tpu_torch.kernels import sc_attention as katt
    from pointdsc_tpu_torch.kernels import scoring as kscore
    from pointdsc_tpu_torch.kernels import seed_knn as kknn

    x = kernel_inputs(torch, dev)
    src, tgt, mask = x["src"], x["tgt"], x["mask"]
    q, k, v = x["qkv"]
    rows = []

    def row(name, source, replaces, err, fn, plain_fn, bytes_moved, ops, tensor_ops=None,
            reps=20, **extra):
        # ops counts every operation; tensor_ops of them have bf16 operands
        if tensor_ops is None:
            b, o = bound_ms(bytes_moved, ops)
        else:
            b, o = bound_ms(bytes_moved, ops - tensor_ops, tensor_ops)
            fb, fo = bound_ms(bytes_moved, ops)
            extra.update(bound_ms_f32_cores=fb, bound_by_f32_cores=fo)
        rows.append(dict(name=name, route="cuda",
                         source=f"pointdsc_tpu_torch/kernels/csrc/{source}",
                         replaces=f"pointdsc_tpu/kernels/{replaces}", max_abs_err=err,
                         ms=time_ms(fn, reps=reps), plain_ms=time_ms(plain_fn, reps=reps),
                         bound_ms=b, bound_by=o, library_ms=None, **extra))

    # -- int8 cache. Tolerance: the kernel's fused multiply-adds round the
    # gram-form distances differently from cuBLAS's, so an entry whose
    # 127 * compat lies within an ulp-sized distance of a .5 boundary may
    # round the other way: equal except for <= 0.1% of entries off by 1.
    geom = katt.pack_geometry(src, tgt, mask)
    coef = katt.cache_coef(0.1)
    cache = katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    diff = (cache.int() - katt.compat_cache_plain(geom, coef).int()).abs()
    off1 = int((diff == 1).sum())
    check(int(diff.max()) <= 1, f"cache differs by {int(diff.max())}")
    check(off1 <= 1e-3 * N * N, f"cache: {off1} entries off by 1")
    row("compat_cache_int8", "compat_cache.cu", "sc_attention.py:236", float(diff.max()),
        lambda: katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask),
        lambda: katt.compat_cache_plain(katt.pack_geometry(src, tgt, mask), coef),
        src.numel() * 4 * 2 + N + N * N, N * N * OPS_PER_CACHE_ENTRY, off_by_one=off1)

    # -- attention on the kernel's own cache. Tolerance atol = rtol = 1e-4:
    # f32 throughout; the flash loop sums 5120 keys in 80 tiles with a
    # rescale per tile, the plain version in one matmul with one max.
    bias = geom[:, 8].contiguous()
    out = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                         offset_softmax=False)
    ref = katt.sc_attention_cached_plain(q, k, v, cache, bias)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=1e-4, rtol=1e-4), f"attention max err {err}")
    attn_bytes = 3 * N * C * 4 + N * N + N * 4 + N * C * 4
    attn_ops = 4.0 * N * N * C + OPS_PER_ATTN_PAIR_EXTRA * N * N
    row("sc_attention_cached", "sc_attention.cu", "sc_attention.py:417", err,
        lambda: katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                               offset_softmax=False),
        lambda: katt.sc_attention_cached_plain(q, k, v, cache, bias), attn_bytes, attn_ops)

    # -- offset attention on the same cache, at the shapes and types the
    # half-precision path gives it: bf16 q, k, v, and p rounded to bf16 before
    # p v. Tolerance atol = rtol = 2e-3: a p whose f32 value sits on a bf16
    # rounding boundary may round either way in the two versions (their
    # exponents' arguments differ in the last bit), each such flip moving one
    # of 5120 terms of a row by 2^-9 relative; measured ~1e-4. f32 inputs are
    # rounded to bf16 by the wrapper: the same result, bit for bit.
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = katt.fused_sc_attention_cached(qh, kh, vh, cache, src, tgt, mask=mask)
    ref = katt.sc_attention_cached_offset_plain(qh, kh, vh, cache, bias)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=2e-3, rtol=2e-3), f"offset attention max err {err}")
    check(torch.equal(katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask), out),
          "offset attention: f32 inputs are not the bf16 inputs' result")
    row("sc_attention_cached_offset", "sc_attention.cu", "sc_attention.py:472", err,
        lambda: katt.fused_sc_attention_cached(qh, kh, vh, cache, src, tgt, mask=mask),
        lambda: katt.sc_attention_cached_offset_plain(qh, kh, vh, cache, bias),
        attn_bytes - 3 * N * C * 2, attn_ops, tensor_ops=4.0 * N * N * C)

    # -- the whole encoder layer in one launch, N = 5120. Tolerance
    # atol = rtol = 2e-3: q, k, v and p are rounded to bf16 in both versions,
    # whose f32 sums run in another order; a value on a rounding boundary may
    # round either way, which moves one logit by 2^-9 relative or one of 5120
    # terms of a row's sum by as much. Activations are ~1; measured ~1e-4.
    lay = layer_inputs(torch, dev, N, 0.1)
    x5, w5, c5, kb5 = lay["x"], lay["weights"], lay["cache"], lay["kbias"]
    out = kenc.fused_encoder_layer(x5, c5, kb5, w5)
    ref = kenc.fused_layer_plain(x5, c5, kb5, w5)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=2e-3, rtol=2e-3), f"fused encoder layer max err {err}")
    cnt = layer_counts(N)
    row("fused_encoder_layer", "encoder_layer.cu", "encoder_layer.py:109", err,
        lambda: kenc.fused_encoder_layer(x5, c5, kb5, w5),
        lambda: kenc.fused_layer_plain(x5, c5, kb5, w5),
        2 * cnt["act"] + cnt["cache"] + cnt["w_a"] + cnt["w_b"],
        cnt["ops_a"] + cnt["ops_b"] + cnt["attn"] + cnt["attn_extra"], tensor_ops=cnt["attn"])
    del lay, x5, w5, c5, kb5, out, ref

    # -- the split pair, N = 12288 (a pair at the SyntheticKITTI scale,
    # sigma_d = 1.2). PointCN + QKV: h atol = rtol = 1e-5 (f32 dot products of
    # 128 terms in another order); q, k, v equal in bf16 except at rounding
    # boundaries (by one step, on <= 0.1% of entries); kscale rtol 1e-5.
    lay = layer_inputs(torch, dev, N_KITTI, 1.2, **KITTI_DATA)
    xk, wk, ck, kbk = lay["x"], lay["weights"], lay["cache"], lay["kbias"]
    got = kenc.pcn_qkv(xk, wk)
    ref = kenc.pcn_qkv_plain(xk, wk)
    err = float((got[0] - ref[0]).abs().max())
    check(torch.allclose(got[0], ref[0], atol=1e-5, rtol=1e-5), f"pcn_qkv h max err {err}")
    flips = 0
    for a, b in zip(got[1:4], ref[1:4]):
        d = (a.float() - b.float()).abs()
        check(bool((d <= b.float().abs() * 2.0 ** -7).all()), "pcn_qkv: q/k/v off by > 1 step")
        flips += int((d > 0).sum())
    check(flips <= 1e-3 * 3 * N_KITTI * C, f"pcn_qkv: {flips} bf16 entries differ")
    check(torch.allclose(got[4], ref[4], atol=0, rtol=1e-5), "pcn_qkv: kscale differs")
    cnt = layer_counts(N_KITTI)
    row("pcn_qkv", "encoder_layer.cu", "encoder_layer.py:272", err,
        lambda: kenc.pcn_qkv(xk, wk), lambda: kenc.pcn_qkv_plain(xk, wk),
        2 * cnt["act"] + 3 * cnt["half"] + cnt["w_a"] + 4, cnt["ops_a"], reps=10,
        bf16_entries_off_by_one=flips)

    # -- attention + MLP + residual on the plain version's h, q, k, v, kscale.
    # Tolerance atol = rtol = 2e-3, for the p rounding as above (12288 terms).
    h, qb, kb_, vb, ks = ref
    out = kenc.attn_mlp_residual(ks, qb, kb_, vb, ck, kbk, h, wk)
    ref2 = kenc.attn_mlp_residual_plain(ks, qb, kb_, vb, ck, kbk, h, wk)
    err = float((out - ref2).abs().max())
    check(torch.allclose(out, ref2, atol=2e-3, rtol=2e-3), f"attn_mlp_residual max err {err}")
    row("attn_mlp_residual", "encoder_layer.cu", "encoder_layer.py:326", err,
        lambda: kenc.attn_mlp_residual(ks, qb, kb_, vb, ck, kbk, h, wk),
        lambda: kenc.attn_mlp_residual_plain(ks, qb, kb_, vb, ck, kbk, h, wk),
        2 * cnt["act"] + 3 * cnt["half"] + cnt["cache"] + cnt["w_b"] + 4,
        cnt["ops_b"] + cnt["attn"] + cnt["attn_extra"], tensor_ops=cnt["attn"], reps=10)
    del lay, xk, wk, ck, kbk, got, ref, ref2, out, h, qb, kb_, vb, ks
    torch.cuda.empty_cache()

    # -- confidence head. Tolerance atol = rtol = 1e-5: f32 dot products of
    # 128 and 32 terms summed in another order than cuBLAS's.
    head = x["head"]
    logits = kconf.confidence_head(q, *head)
    ref = kconf.confidence_head_plain(q, *head)
    err = float((logits - ref).abs().max())
    check(torch.allclose(logits, ref, atol=1e-5, rtol=1e-5), f"confidence head max err {err}")
    row("confidence_head", "conf_mlp.cu", "conf_mlp.py:43", err,
        lambda: kconf.confidence_head(q, *head), lambda: kconf.confidence_head_plain(q, *head),
        N * C * 4 + sum(t.numel() for t in head) * 4 + N * 4, N * OPS_PER_CONF_ROW)

    # -- NMS flags. Tolerance: the kernel's and cuBLAS's gram-form d2 round
    # differently, so a pair with |d2 - R^2| < 1e-5 may fall on either side
    # of the radius: flags equal except on queries that have such a pair.
    scores = x["scores"]
    ngeom = knms.pack_nms_geometry(src, scores, mask)
    r2 = knms.radius_sq(0.1)
    flags = knms.nms_local_max(src, scores, 0.1, mask=mask)
    ref = knms.nms_local_max_plain(ngeom, r2)
    xyz = ngeom[:, 0:3]
    d2 = torch.clamp(ngeom[:, 3, :, None] + ngeom[:, 3, None, :]
                     - 2.0 * (xyz.transpose(1, 2) @ xyz), min=0.0)
    near = torch.any((d2 - r2).abs() < 1e-5, dim=-1)
    bad = (flags != ref) & ~near
    check(not bool(bad.any()), f"NMS flags differ on {int(bad.sum())} far-from-boundary points")
    row("nms_local_max", "nms.cu", "nms.py:40", float((flags - ref).abs().max()),
        lambda: knms.nms_local_max(src, scores, 0.1, mask=mask),
        lambda: knms.nms_local_max_plain(knms.pack_nms_geometry(src, scores, mask), r2),
        src.numel() * 4 + N * 4 * 2 + N * 4, N * N * OPS_PER_NMS_PAIR)

    # -- seed k-NN. Tolerance: index sets equal except at near ties of the
    # k-th similarity (see knn_sets_agree); never a seed itself or a padded
    # point.
    feats = torch.nn.functional.normalize(q, dim=-1).contiguous()
    seeds = x["seeds"]
    idx = kknn.seed_knn_exact(feats, seeds, K, mask=mask)
    kb = kknn.knn_bias(mask, feats)
    ref = kknn.seed_knn_plain(feats, seeds, K, kb)
    sim = torch.einsum("bsc,bnc->bsn", torch.gather(feats, 1, seeds[..., None].expand(-1, -1, C)),
                       feats)
    check(knn_sets_agree(torch, idx, ref, sim, K), "seed k-NN sets differ beyond near ties")
    check(bool(torch.gather(mask[:, None].expand(-1, S, -1), 2, idx).all())
          and not bool((idx == seeds[..., None]).any()), "seed k-NN returned a padded/self index")
    row("seed_knn_exact", "seed_knn.cu", "seed_knn.py:48",
        float((torch.gather(sim, -1, idx) - torch.gather(sim, -1, ref)).abs().max()),
        lambda: kknn.seed_knn_exact(feats, seeds, K, mask=mask),
        lambda: kknn.seed_knn_plain(feats, seeds, K, kknn.knn_bias(mask, feats)),
        N * C * 4 + N * 4 + S * 8 + S * K * 8, S * N * OPS_PER_KNN_PAIR)

    # -- scoring. Tolerance: a point whose squared residual is within 1e-5 of
    # tau^2 may be counted by one version and not the other (FMA rounding),
    # so per seed |count - plain| <= the number of such points.
    trans = x["trans"]
    t2 = kscore.thr_sq(0.1)
    counts = kscore.seed_inlier_counts(trans, src, tgt, 0.1, mask=mask)
    ref = kscore.seed_inlier_counts_plain(kscore.pack_scoring_trans(trans),
                                          kscore.pack_scoring_points(src, tgt, mask), t2)
    pred = torch.einsum("bsij,bnj->bsni", trans[:, :, :3, :3], src) + trans[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    near = torch.sum(((res2 - t2).abs() < 1e-5) & mask[:, None, :], dim=-1)
    cdiff = (counts - ref).abs()
    check(bool(torch.all(cdiff <= near)), f"counts differ by up to {float(cdiff.max())}")
    check(float(counts.sum()) > 0, "scoring counted no inliers")
    row("seed_inlier_counts", "scoring.cu", "scoring.py:56", float(cdiff.max()),
        lambda: kscore.seed_inlier_counts(trans, src, tgt, 0.1, mask=mask),
        lambda: kscore.seed_inlier_counts_plain(kscore.pack_scoring_trans(trans),
                                                kscore.pack_scoring_points(src, tgt, mask), t2),
        S * 16 * 4 + src.numel() * 4 * 2 + N * 4 + S * 4, S * N * OPS_PER_SCORING_PAIR)

    # -- post-refinement. Tolerance atol 1e-4 on the transform: the kernel
    # sums the Gram terms in another order than the plain einsums and solves
    # in the same f32 closed form. The bound counts the rounds that ran.
    init = x["init"]
    out, iters = kref.fused_post_refinement(init, src, tgt, mask, 0.1, 20, return_iters=True)
    ref = kref.fused_post_refinement_plain(init, src, tgt, mask, 0.1, 20)
    err = float((out - ref).abs().max())
    check(err <= 1e-4, f"post-refinement max err {err}")
    rounds = int(iters.sum())
    row("fused_post_refinement", "refine.cu", "refine.py:55", err,
        lambda: kref.fused_post_refinement(init, src, tgt, mask, 0.1, 20),
        lambda: kref.fused_post_refinement_plain(init, src, tgt, mask, 0.1, 20),
        8 * N * 4 + 2 * 16 * 4, rounds * N * OPS_PER_REFINE_POINT, rounds=rounds)
    return rows


def seed_checks(torch, out, model, cp, src, tgt, tag: str) -> None:
    """Hold the run's seeds and seed fitness against the dense oracles on
    the run's own confidences and seed transforms."""
    from pointdsc_tpu_torch.ops.knn import pairwise_dists_exact
    from pointdsc_tpu_torch.ops.nms import pick_seeds_nms

    # NMS: the dense NMS (exact distances) on the same confidences. A flag
    # may differ only for a pair at |d - R| of a rounding, and one flip
    # shifts later positions, so the sets are compared: overlap >= 0.99.
    oracle = pick_seeds_nms(pairwise_dists_exact(src), out.confidence, model.nms_radius, S)
    same_pos = float((oracle == out.seeds).float().mean())
    overlap = len(set(oracle[0].tolist()) & set(out.seeds[0].tolist())) / S
    # scoring: the [S, N] inlier count of the run's own seed transforms; a
    # point within 1e-5 of tau^2 may count either way.
    st = out.seed_trans
    pred = torch.einsum("bsij,bnj->bsni", st[:, :, :3, :3], src) + st[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    t2 = model.inlier_threshold ** 2
    counts = torch.sum(res2 < t2, dim=-1).float()
    near = torch.sum((res2 - t2).abs() < 1e-5, dim=-1)
    fdiff = (out.seed_fitness * N - counts).abs()
    positive = float((out.confidence > 0).float().mean())
    print(f"{tag}: positive logits {positive:.4f}, seeds vs dense NMS on the same "
          f"confidences: same position {same_pos:.4f}, set overlap {overlap:.4f}; seed "
          f"fitness vs [S, N] count max diff {float(fdiff.max()):.1f} points", flush=True)
    check(overlap >= 0.99, f"{tag}: seeds disagree with the dense NMS")
    check(bool(torch.all(fdiff <= near + 1e-3)), f"{tag}: seed fitness disagrees with the count")


RUNNING_MAX_KERNELS = ("compat_cache_int8", "sc_attention_cached", "confidence_head",
                       "nms_local_max", "seed_knn_exact", "seed_inlier_counts",
                       "fused_post_refinement")


class Recorded:
    """An Evaluator whose forwards are recorded (transform and labels of every
    call, the warm-up included), so that run_dataset's results can be held
    against the dense path."""

    def __init__(self, evaluator):
        self.ev = evaluator
        self.calls = []
        inner = evaluator._forward

        def forward(*args):
            out = inner(*args)
            self.calls.append(out)
            return out

        evaluator._forward = forward


def run_cell(torch, pt, kernels, dev, tag, model, ds, expect, trans_atol, golden=None):
    """Drive ``Evaluator.run_dataset`` over ds with the counts set to 0 just
    before and read just after; hold every pair against the dense path (and
    the golden file), print the guard's slack and the aggregate recall.
    ``expect``: kernel name -> launches per forward. Returns the counts."""
    import numpy as np

    rec = Recorded(pt.Evaluator(model, fused_attention=True, device=DEVICE))
    torch.cuda.synchronize()
    kernels.reset_launches()
    stats, agg = rec.ev.run_dataset(ds, verbose=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    forwards = len(rec.calls)  # the pairs and one warm-up per bucket
    print(f"{tag}: launches over {forwards} forwards ({len(ds)} pairs + warm-up): "
          f"{json.dumps(counts)}", flush=True)
    print(f"{tag}: guard slack of the last probe {rec.ev.last_slack:.3f} nats, flipped "
          f"{rec.ev.flipped}; registration recall {agg['pair_recall']:.1f}%, RE "
          f"{agg['re']:.4f} deg, TE {agg['te']:.4f} cm, model_time "
          f"{agg['model_time'] * 1e3:.3f} ms", flush=True)
    check(forwards == len(ds) + 1, f"{tag}: {forwards} forwards for {len(ds)} pairs")
    for name, count in counts.items():
        want = expect.get(name, 0) * forwards
        check(count == want, f"{tag}: {name} launched {count} times, expected {want}")
    check(np.isfinite(stats).all() and stats.shape == (len(ds), 12), f"{tag}: bad stats")

    for i in range(len(ds)):
        p = ds[i]
        trans, labels = rec.calls[forwards - len(ds) + i]
        n = p["corr_pos"].shape[0]
        cp, src, tgt = (torch.as_tensor(p[k])[None].to(dev)
                        for k in ("corr_pos", "src_keypts", "tgt_keypts"))
        check(trans.shape == (1, 4, 4) and bool(torch.isfinite(trans).all()),
              f"{tag} pair {i}: bad final_trans")
        dense = rec.ev.model(cp, src, tgt, mask=torch.ones((1, n), dtype=torch.bool, device=dev),
                             fused=False)
        terr = float((trans - dense.final_trans).abs().max())
        agree = float((labels[:, :n] == dense.final_labels).float().mean())
        print(f"{tag} pair {i}: fused-vs-dense final_trans max err {terr:.3e}, label agreement "
              f"{agree:.4f}, success {stats[i, 0]:.0f}", flush=True)
        check(terr <= trans_atol and agree > 0.99, f"{tag} pair {i}: disagrees with dense")
        if golden is not None:
            gerr = float(np.abs(trans[0].cpu().numpy() - golden["final_trans"][i]).max())
            gagree = float(((labels[0, :n].cpu().numpy() > 0.5)
                            == golden["final_labels"][i]).mean())
            print(f"{tag} pair {i}: vs JAX golden final_trans max err {gerr:.3e}, label "
                  f"agreement {gagree:.4f}", flush=True)
            check(gerr <= 1e-3 and gagree > 0.99, f"{tag} pair {i}: disagrees with JAX golden")
    return rec, counts


def default_configuration(torch, pt, kernels, dev) -> dict:
    """Phases 8 to 11. Returns the launches of the four kernels of these
    paths, each from its own path's run."""
    import numpy as np

    from pointdsc_tpu_torch.data import SyntheticPairDataset

    tail = {"compat_cache_int8": 1, "confidence_head": 1, "nms_local_max": 1,
            "seed_knn_exact": 1, "seed_inlier_counts": 1, "fused_post_refinement": 1}
    launches = {}

    # 8a. Synthetic snapshot, N = 5120: one kernel per layer. Against the
    # dense path: final_trans atol 1e-3, labels > 0.99 (the JAX suite's
    # fused-vs-dense bound), and the same against the JAX dense golden file.
    model = pt.load_pretrained(SNAPSHOT, device=DEVICE)
    ds = SyntheticPairDataset(num_pairs=PAIRS, num_corr=N, **DEFAULT_DATA)
    gold = np.load(GOLDEN_DEFAULT)
    check(int(gold["n"]) == N and int(gold["seed"]) == DEFAULT_DATA["seed"], "wrong golden file")
    rec, counts = run_cell(torch, pt, kernels, dev, "default N=5120", model, ds,
                           {**tail, "fused_encoder_layer": 12}, 1e-3, golden=gold)
    check(not rec.ev.flipped, "the guard flipped on the Synthetic snapshot")
    launches["fused_encoder_layer"] = counts["fused_encoder_layer"]

    # 8b. SyntheticKITTI snapshot, N = 12288: the pair of kernels per layer.
    # Coordinates reach ~90 m, so f32 carries ~1e-5 m; the fused and the dense
    # path refine to the same inlier set: rotation and translation agree to
    # 5e-3 (metres for the translation column), labels > 0.99.
    kitti = pt.load_pretrained(SNAPSHOT_KITTI, device=DEVICE)
    check(kitti.sigma_d == 1.2 and kitti.inlier_threshold == 0.6, "not the KITTI configuration")
    ds_k = SyntheticPairDataset(num_pairs=PAIRS_KITTI, num_corr=N_KITTI, **DEFAULT_DATA_KITTI,
                                **KITTI_DATA)
    rec_k, counts = run_cell(torch, pt, kernels, dev, "default N=12288", kitti, ds_k,
                             {**tail, "pcn_qkv": 12, "attn_mlp_residual": 12}, 5e-3)
    check(not rec_k.ev.flipped, "the guard flipped on the SyntheticKITTI snapshot")
    launches["pcn_qkv"] = counts["pcn_qkv"]
    launches["attn_mlp_residual"] = counts["attn_mlp_residual"]

    # 9. half precision: the per-op bf16 encoder around the offset attention
    # kernel, held against the f32 model's dense path. bf16 activations
    # through twelve layers move the features by ~1e-2, but the refinement
    # converges to the same inliers: final_trans atol 1e-3, labels > 0.99.
    half = pt.load_pretrained(SNAPSHOT, device=DEVICE, half_precision=True)
    one = SyntheticPairDataset(num_pairs=1, num_corr=N, **DEFAULT_DATA)
    rec_h, counts = run_cell(torch, pt, kernels, dev, "half precision N=5120", half, one,
                             {**tail, "sc_attention_cached_offset": 12}, 1e-3,
                             golden={k: gold[k][:1] for k in ("final_trans", "final_labels")})
    check(not rec_h.ev.flipped, "the guard flipped in half precision")
    launches["sc_attention_cached_offset"] = counts["sc_attention_cached_offset"]

    # 10. a copy with every key projection scaled by 100: far out of regime,
    # the guard switches to the running-max kernel before any recorded
    # forward; its result is the dense path's of the same weights (atol 5e-3,
    # the JAX suite's bound for this case: logits a hundred times larger also
    # magnify the int8 cache's quantisation)
    bad = pt.load_pretrained(SNAPSHOT, device=DEVICE)
    with torch.no_grad():
        for i in range(bad.encoder.num_layers):
            proj = getattr(bad.encoder, f"NonLocal_layer_{i}").projection_k
            proj.weight.mul_(100.0)
            proj.bias.mul_(100.0)
    rec_b, _ = run_cell(torch, pt, kernels, dev, "scaled keys N=5120", bad, one,
                        {**tail, "sc_attention_cached": 12}, 5e-3)
    check(rec_b.ev.flipped and rec_b.ev.model.offset_softmax is False,
          "the guard did not flip on the scaled copy")

    # 11. the default forward's time, as phase 7
    for tag, m, data, n in (("default", model, ds[0], N), ("default", kitti, ds_k[0], N_KITTI),
                            ("half_precision", half, ds[0], N)):
        ms = time_ms(lambda: pt.register(data["corr_pos"], data["src_keypts"],
                                         data["tgt_keypts"], model=m, device=DEVICE),
                     reps=10, warmup=2)
        print(json.dumps({"metric": "fused_forward_ms_per_pair", "config": tag, "n": n,
                          "value": ms}), flush=True)
    return launches


TRAIN_KERNELS = ("sc_attention_forward", "sc_attention_backward_dq", "sc_attention_backward_dkv",
                 "sm_loss_sums", "sm_loss_grads")


def train_batch(bs, node, seed=3, inlier_ratio=0.35, **data):
    """A collated numpy batch of bs synthetic pairs of ``node`` correspondences,
    padded to their bucket with a mask (data/pipeline.py)."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset, collate_batch

    ds = SyntheticPairDataset(num_pairs=bs, num_corr=node, inlier_ratio=inlier_ratio, seed=seed,
                              **data)
    return collate_batch([ds[i] for i in range(bs)])


def check_train_kernels(torch, dev) -> list[dict]:
    """Phase 12: the training kernels' public entries against their plain
    versions at bs 16 / N = 1024 (24 padded points per sample), the attention
    trio also at one sample of N = 12288 in the KITTI regime.

    ``library_ms`` is null for all: the compat factor multiplies the logits,
    which ``scaled_dot_product_attention``'s additive mask cannot express, and
    the SM loss never forms M, which every PyTorch call that could compute it
    would. All operands are f32, so every operation counts at the f32 rate."""
    from pointdsc_tpu_torch.kernels import sc_attention as katt
    from pointdsc_tpu_torch.kernels import sm_loss as ksm
    from pointdsc_tpu_torch.ops.compatibility import feature_similarity
    from pointdsc_tpu_torch.train.losses import spectral_matching_loss

    rows = []

    def row(name, source, replaces, err, fn, plain_fn, bytes_moved, ops, reps=20, **extra):
        b, o = bound_ms(bytes_moved, ops)
        rows.append(dict(name=name, route="cuda",
                         source=f"pointdsc_tpu_torch/kernels/csrc/{source}",
                         replaces=f"pointdsc_tpu/kernels/{replaces}", max_abs_err=err,
                         ms=time_ms(fn, reps=reps), plain_ms=time_ms(plain_fn, reps=reps),
                         bound_ms=b, bound_by=o, library_ms=None, **extra))

    def attention_case(bs, n, sigma_d, batch, seed):
        src, tgt = (torch.as_tensor(batch[k]).to(dev) for k in ("src_keypts", "tgt_keypts"))
        mask = torch.as_tensor(batch["mask"]).to(dev)
        gen = torch.Generator().manual_seed(seed)
        q, k, v, d_out = (torch.randn((bs, n, C), generator=gen).to(dev) for _ in range(4))
        geom = katt.pack_geometry(src, tgt, mask)
        ref, ref_lse = katt.sc_attention_forward_plain(q, k, v, geom, sigma_d)
        dvec = torch.sum(d_out * ref, dim=-1)
        bwd = (q, k, v, geom, ref_lse, dvec, d_out, sigma_d)
        return dict(fwd=(q, k, v, geom, sigma_d), bwd=bwd, ref=ref, ref_lse=ref_lse,
                    ref_grads=katt.sc_attention_backward_plain(*bwd))

    def attention_errors(case, tag):
        """Tolerances: compat is the same bit for bit in kernel and plain
        version (rounded operations in one order), the 128-term logits and the
        N-term sums run in another order: out and lse atol = rtol = 1e-4, the
        gradients (terms of either sign) 2e-4 at N = 1024 and 5e-4 at
        N = 12288."""
        tol = 2e-4 if case["ref"].shape[1] <= 2048 else 5e-4
        out, lse = katt.sc_attention_forward(*case["fwd"])
        e_out = float((out - case["ref"]).abs().max())
        e_lse = float((lse - case["ref_lse"]).abs().max())
        check(torch.allclose(out, case["ref"], atol=1e-4, rtol=1e-4)
              and torch.allclose(lse, case["ref_lse"], atol=1e-4, rtol=1e-4),
              f"{tag}: attention forward max err out {e_out}, lse {e_lse}")
        dq = katt.sc_attention_backward_dq(*case["bwd"])
        dk, dv = katt.sc_attention_backward_dkv(*case["bwd"])
        errs = {}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), case["ref_grads"]):
            errs[name] = float((got - ref).abs().max())
            check(torch.allclose(got, ref, atol=tol, rtol=tol),
                  f"{tag}: attention backward {name} max err {errs[name]}")
        print(f"{tag}: attention kernels vs plain: out {e_out:.3e}, lse {e_lse:.3e}, dq "
              f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e}", flush=True)
        return max(e_out, e_lse), errs["dq"], max(errs["dk"], errs["dv"])

    def attention_counts(bs, n):
        """(bytes, operations) of forward, dQ and dK, dV."""
        act, vec, pairs = bs * n * C * 4, bs * n * 4, float(bs) * n * n
        geom = 16 * vec
        extra_f = OPS_PER_COMPAT_PAIR + OPS_PER_ATTN_PAIR_EXTRA
        extra_b = OPS_PER_COMPAT_PAIR + OPS_PER_ATTN_BWD_PAIR_EXTRA
        return ((4 * act + geom + vec, pairs * (4 * C + extra_f)),
                (5 * act + geom + 2 * vec, pairs * (6 * C + extra_b)),
                (6 * act + geom + 2 * vec, pairs * (8 * C + extra_b)))

    # -- the attention trio at the training shape, and at the KITTI scale
    main = attention_case(TRAIN_BS, TRAIN_N, 0.1, train_batch(TRAIN_BS, TRAIN_NODE), seed=4)
    e_f, e_q, e_kv = attention_errors(main, f"bs {TRAIN_BS} N={TRAIN_N}")
    big = attention_case(1, N_KITTI, 1.2, train_batch(1, N_KITTI, **KITTI_DATA), seed=5)
    b_f, b_q, b_kv = attention_errors(big, f"bs 1 N={N_KITTI}")
    cm, cb = attention_counts(TRAIN_BS, TRAIN_N), attention_counts(1, N_KITTI)
    entries = (
        ("sc_attention_forward", "sc_attention.py:649", e_f, b_f,
         lambda c: katt.sc_attention_forward(*c["fwd"]),
         lambda c: katt.sc_attention_forward_plain(*c["fwd"])),
        ("sc_attention_backward_dq", "sc_attention.py:710", e_q, b_q,
         lambda c: katt.sc_attention_backward_dq(*c["bwd"]),
         lambda c: katt.sc_attention_backward_plain(*c["bwd"])),
        ("sc_attention_backward_dkv", "sc_attention.py:742", e_kv, b_kv,
         lambda c: katt.sc_attention_backward_dkv(*c["bwd"]),
         lambda c: katt.sc_attention_backward_plain(*c["bwd"])),
    )
    for i, (name, replaces, err, err_big, fn, plain_fn) in enumerate(entries):
        # the plain backward computes dq, dk and dv at once: its time stands
        # beside both backward kernels
        big_bound, _ = bound_ms(*cb[i])
        row(name, "sc_attention_train.cu", replaces, err, lambda: fn(main),
            lambda: plain_fn(main), *cm[i],
            n12288=dict(max_abs_err=err_big, ms=time_ms(lambda: fn(big), reps=5, warmup=1),
                        plain_ms=time_ms(lambda: plain_fn(big), reps=5, warmup=1),
                        bound_ms=big_bound))
    del main, big
    torch.cuda.empty_cache()

    # -- the eval attention without a cache, at its path's shape (one pair of
    # N = 5120): the forward kernel without the LSE store, so out is the
    # trainable forward's bit for bit. Tolerance as above.
    x = kernel_inputs(torch, dev)
    q, k, v = x["qkv"]
    geom = katt.pack_geometry(x["src"], x["tgt"], x["mask"])
    out = katt.fused_sc_attention(q, k, v, x["src"], x["tgt"], 0.1, mask=x["mask"])
    ref, _ = katt.sc_attention_forward_plain(q, k, v, geom, 0.1)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=1e-4, rtol=1e-4), f"fused_sc_attention max err {err}")
    check(torch.equal(out, katt.sc_attention_forward(q, k, v, geom, 0.1)[0]),
          "fused_sc_attention is not the trainable forward's out")
    (bytes_f, ops_f), _, _ = attention_counts(1, N)
    row("fused_sc_attention", "sc_attention_train.cu", "sc_attention.py:82", err,
        lambda: katt.fused_sc_attention(q, k, v, x["src"], x["tgt"], 0.1, mask=x["mask"]),
        lambda: katt.sc_attention_forward_plain(q, k, v, katt.pack_geometry(
            x["src"], x["tgt"], x["mask"]), 0.1), bytes_f - N * 4, ops_f)
    del x, q, k, v, geom, out, ref

    # -- SM loss at the training shape: unit features, the batch's labels and
    # mask, sigma off its initial 1 so that both sides of the clamp are live.
    # Tolerances: the sums (N^2 non-negative terms, added per tile then over
    # tiles) rtol 1e-5; dF 1e-5 of its largest entry; dsigma rtol 1e-4. A pair
    # whose u lies within rounding of 0 or 1 may fall on either side of the
    # gate in the two versions: one term of weight ~1/N^2.
    batch = train_batch(TRAIN_BS, TRAIN_NODE)
    gen = torch.Generator().manual_seed(6)
    f = torch.nn.functional.normalize(torch.randn((TRAIN_BS, TRAIN_N, C), generator=gen),
                                      dim=-1).to(dev)
    gt = torch.as_tensor(batch["gt_labels"]).to(dev)
    mask = torch.as_tensor(batch["mask"]).to(dev)
    strips = ksm.pack_labels(gt, mask)
    wp, wn = ksm.balance_weights(strips, balanced=False)
    sigma = torch.full((TRAIN_BS,), 1.07, device=dev)
    scalars = torch.stack([sigma, wp, wn, torch.zeros_like(wp)], dim=-1).contiguous()
    got, ref = ksm.sm_loss_sums(f, strips, scalars), ksm.sm_loss_sums_plain(f, strips, scalars)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(all(torch.allclose(a, b, atol=0, rtol=1e-5) for a, b in zip(got, ref)),
          f"SM-loss sums max err {err}")
    pairs = float(TRAIN_BS) * TRAIN_N * TRAIN_N
    act, strip_bytes = TRAIN_BS * TRAIN_N * C * 4, strips.numel() * 4 + scalars.numel() * 4
    tiles = -(-TRAIN_N // ksm.TILE)
    row("sm_loss_sums", "sm_loss.cu", "sm_loss.py:87", err,
        lambda: ksm.sm_loss_sums(f, strips, scalars),
        lambda: ksm.sm_loss_sums_plain(f, strips, scalars),
        act + strip_bytes + TRAIN_BS * tiles * tiles * 8, pairs * (2 * C + OPS_PER_SM_PAIR))
    (df, ds), (rdf, rds) = ksm.sm_loss_grads(f, strips, scalars), \
        ksm.sm_loss_grads_plain(f, strips, scalars)
    err = float((df - rdf).abs().max())
    check(err <= 1e-5 * float(rdf.abs().max()), f"SM-loss dF max err {err}")
    check(torch.allclose(ds, rds, atol=0, rtol=1e-4),
          f"SM-loss dsigma max err {float((ds - rds).abs().max())}")
    row("sm_loss_grads", "sm_loss.cu", "sm_loss.py:108", err,
        lambda: ksm.sm_loss_grads(f, strips, scalars),
        lambda: ksm.sm_loss_grads_plain(f, strips, scalars),
        2 * act + strip_bytes + TRAIN_BS * tiles * 4, pairs * (4 * C + OPS_PER_SM_BWD_PAIR),
        dsigma_max_abs_err=float((ds - rds).abs().max()))

    # the public entry against the dense chain it replaces, value and gradients
    grads = []
    for fused in (True, False):
        ff = f.clone().requires_grad_()
        sg = torch.tensor([1.07], device=dev, requires_grad=True)
        if fused:
            loss = ksm.fused_spectral_matching_loss(ff, sg, gt, mask, False)
        else:
            loss = spectral_matching_loss(feature_similarity(ff, sg, mask=mask), gt, mask,
                                          balanced=False)
        loss.backward()
        grads.append((loss.detach(), ff.grad, sg.grad))
    (lf, dff, dsf), (ld, dfd, dsd) = grads
    print(f"fused_spectral_matching_loss vs the dense chain: loss {float(lf):.6f} / "
          f"{float(ld):.6f}, dF max err {float((dff - dfd).abs().max()):.3e} of "
          f"{float(dfd.abs().max()):.3e}, dsigma {float(dsf):.6e} / {float(dsd):.6e}", flush=True)
    check(torch.allclose(lf, ld, atol=0, rtol=1e-5)
          and float((dff - dfd).abs().max()) <= 1e-5 * float(dfd.abs().max())
          and torch.allclose(dsf, dsd, atol=0, rtol=1e-4),
          "fused_spectral_matching_loss disagrees with the dense chain")
    return rows


def no_cache_forward(torch, pt, kernels, dev) -> int:
    """Phase 13: the eval forward with ``fused_cache_compat=False`` on one
    Synthetic pair at N = 5120: twelve launches of the no-cache attention and
    no cache build, held against the dense path as in phase 4 (the f32 compat
    tile is closer to the dense path's than the int8 cache)."""
    from pointdsc_tpu_torch.data import SyntheticPairDataset

    model = pt.load_pretrained(SNAPSHOT, device=DEVICE, fused_cache_compat=False)
    p = SyntheticPairDataset(num_pairs=1, num_corr=N, **DEFAULT_DATA)[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"], model=model,
                      device=DEVICE)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"no-cache forward launches: {json.dumps(counts)}", flush=True)
    check(counts["fused_sc_attention"] == 12 and counts["compat_cache_int8"] == 0
          and counts["fused_encoder_layer"] == 0, "the no-cache forward took another path")
    cp, src, tgt = (torch.as_tensor(p[k])[None].to(dev)
                    for k in ("corr_pos", "src_keypts", "tgt_keypts"))
    with torch.no_grad():
        dense = model(cp, src, tgt, fused=False)
    terr = float((out.final_trans - dense.final_trans).abs().max())
    agree = float((out.final_labels == dense.final_labels).float().mean())
    print(f"no-cache forward: fused-vs-dense final_trans max err {terr:.3e}, label agreement "
          f"{agree:.4f}", flush=True)
    check(terr <= 1e-3 and agree > 0.99, "the no-cache forward disagrees with dense")
    return counts["fused_sc_attention"]


def training(torch, pt, kernels, dev) -> dict:
    """Phases 14 to 18. Returns the launches of the five training kernels
    over the Trainer's run of phase 15."""
    import tempfile
    import time

    from pointdsc_tpu_torch.data import Loader, SyntheticPairDataset
    from pointdsc_tpu_torch.train.config import default_config
    from pointdsc_tpu_torch.train.trainer import Trainer

    def make(fused, dataset="3DMatch", model=None, **over):
        cfg = default_config(dataset)
        cfg.fused_attention = cfg.fused_sm_loss = fused
        cfg.tboard_dir, cfg.verbose = "", False
        for key, value in over.items():
            setattr(cfg, key, value)
        trainer = Trainer(cfg, model=model, device=DEVICE)
        return trainer, trainer.init_state(steps_per_epoch=TRAIN_STEPS_PER_EPOCH, seed=0)

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30

    # 14. one step, fused against dense, same weights and batch. The two
    # differ in the compat matrix (gram-form distances in the kernels, the
    # difference form in the dense path: ~1e-4 of compat after the division by
    # sigma_d^2) and in summation order. The train-mode forward of the full
    # depth is ill-conditioned: through twelve layers (logits of tens of nats,
    # batch statistics) a difference of one f32 rounding grows by a factor of
    # 2 to 4 per layer, so the dense path moves by ~1e-3 of its own loss when
    # its input moves by 1e-6. The check is therefore made at depth 2 (full
    # width, random weights of seed 0): loss terms rtol 1e-4, each parameter's
    # gradient within 2e-3 of (its largest entry + 1e-2 of the largest entry
    # of all): a bias in front of a training BatchNorm has a true gradient of
    # zero, and what it holds is rounding of the terms that cancel. At depth
    # 12, on the Synthetic snapshot's weights, the same numbers are printed
    # beside the dense path's own movement under a 1e-6 input perturbation,
    # and decide nothing beyond being finite.
    batch = train_batch(TRAIN_BS, TRAIN_NODE)

    def one_step(fused, layers, eps=0.0):
        model = None if layers != 12 else pt.load_pretrained(SNAPSHOT, device=DEVICE)
        trainer, state = make(fused, model=model, num_layers=layers)
        dev_batch = trainer.to_device(batch)
        dev_batch["corr_pos"] = dev_batch["corr_pos"] * (1.0 + eps)
        state, metrics = trainer.train_step(state, dev_batch, 1)
        return ({k: float(v) for k, v in metrics.items()},
                {name: p.grad.clone() for name, p in state.model.named_parameters()})

    def compare(a, b):
        """Largest loss-term and gradient differences of two steps, relative."""
        (ma, ga), (mb, gb) = a, b
        scale = 1e-2 * max(float(g.abs().max()) for g in gb.values())
        worst, worst_name = 0.0, ""
        for name, g in gb.items():
            rel = float((ga[name] - g).abs().max()) / (float(g.abs().max()) + scale)
            if rel > worst:
                worst, worst_name = rel, name
        loss_rel = max(abs(ma[k] - mb[k]) / abs(mb[k]) for k in ("class_loss", "sm_loss"))
        return loss_rel, worst, worst_name

    for layers in (2, 12):
        fused_step, dense_step = one_step(True, layers), one_step(False, layers)
        mf, md = fused_step[0], dense_step[0]
        loss_rel, worst, worst_name = compare(fused_step, dense_step)
        line = (f"train step fused vs dense, {layers} layers: class_loss {mf['class_loss']:.6f} / "
                f"{md['class_loss']:.6f}, sm_loss {mf['sm_loss']:.6f} / {md['sm_loss']:.6f}, "
                f"trans_loss {mf['trans_loss']:.6f} / {md['trans_loss']:.6f}; largest relative "
                f"gradient difference {worst:.3e} ({worst_name}, of {len(dense_step[1])} "
                "parameters)")
        check(mf["grad_finite"] == 1.0 and md["grad_finite"] == 1.0, "a gradient is not finite")
        if layers == 2:
            print(line, flush=True)
            check(loss_rel <= 1e-4, f"loss terms fused vs dense differ by {loss_rel:.3e}")
            check(worst <= 2e-3, f"gradient of {worst_name} differs by {worst:.3e}")
        else:
            own_loss, own_grad, _ = compare(one_step(False, layers, eps=1e-6), dense_step)
            print(f"{line}; the dense path against itself with its input scaled by 1 + 1e-6: "
                  f"loss terms {own_loss:.3e}, gradients {own_grad:.3e} (fused vs dense loss "
                  f"terms {loss_rel:.3e})", flush=True)
        del fused_step, dense_step
    torch.cuda.empty_cache()

    # 15. the Trainer, fused, on the synthetic loader: two epochs of 12 steps,
    # evaluate, save_checkpoint. Counts set to 0 just before, read just after.
    ds = SyntheticPairDataset(num_pairs=TRAIN_BS * TRAIN_STEPS_PER_EPOCH, num_corr=TRAIN_NODE,
                              inlier_ratio=0.35, seed=17)
    val = SyntheticPairDataset(num_pairs=TRAIN_BS * 2, num_corr=TRAIN_NODE, inlier_ratio=0.35,
                               seed=9999)
    # no shuffle: both epochs see the same batches, so their mean losses compare
    loader = Loader(ds, TRAIN_BS, shuffle=False, num_workers=4)
    val_loader = Loader(val, TRAIN_BS, num_workers=4)
    with tempfile.TemporaryDirectory() as tmp:
        trainer, state = make(True, verbose=True, tboard_dir=os.path.join(tmp, "tb"),
                              snapshot_dir=tmp, save_dir=os.path.join(tmp, "models"),
                              training_max_iter=TRAIN_STEPS_PER_EPOCH, val_max_iter=2)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for epoch in (1, 2):
            state = trainer.train_epoch(loader, state, epoch)
        res = trainer.evaluate(val_loader, state)
        path = trainer.save_checkpoint(state, "best")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        trainer.cfg.save(os.path.join(tmp, "config.json"))
        trainer.logger.close()
        # the same eval batches through the dense eval step on the same
        # half-trained weights: a finding, not a check (the fused eval step
        # runs the offset softmax with no regime guard, as the JAX Trainer's)
        dense_trainer, _ = make(False, model=state.model, val_max_iter=2)
        res_dense = dense_trainer.evaluate(val_loader, state)
        print("eval step fused vs dense after the steps: " + ", ".join(
            f"{k} {res[k]:.6f} / {res_dense[k]:.6f}"
            for k in ("class_loss", "sm_loss", "trans_loss", "reg_recall", "f1")), flush=True)
        with open(trainer.logger.path) as fh:
            events = [json.loads(line) for line in fh]
        steps = 2 * TRAIN_STEPS_PER_EPOCH
        print(f"trainer launches over {steps} steps + 2 eval batches: {json.dumps(counts)}",
              flush=True)
        losses = [e["value"] for e in events if e["tag"] == "Train/loss"]
        finite = [e["value"] for e in events if e["tag"] == "Train/grad_finite"]
        print(f"trainer: mean loss of epoch 1 {losses[0]:.6f}, of epoch 2 {losses[1]:.6f}; "
              f"grad_finite {finite}; step {state.step}; "
              f"lr {state.scheduler.get_last_lr()[0]:.6e}; "
              f"eval {json.dumps(res)}; {wall:.1f} s in all", flush=True)
        check(len(losses) == 2 and all(map(math.isfinite, losses)) and losses[1] < losses[0],
              "the training loss is not finite and falling")
        check(finite == [1.0, 1.0], "a step had non-finite gradients")
        check(all(math.isfinite(v) for v in res.values()), "evaluate returned a non-finite metric")
        check(state.step == steps and abs(state.scheduler.get_last_lr()[0]
                                          - 1e-4 * 0.99 ** 2) < 1e-12, "step or schedule count")
        # per train step: 12 forward + 12 dQ + 12 dK,dV launches and one SM
        # forward and backward; per eval batch the cache, 12 whole-layer
        # kernels and the SM forward; scoring and seed k-NN once in each
        expect = {"sc_attention_forward": 12 * steps, "sc_attention_backward_dq": 12 * steps,
                  "sc_attention_backward_dkv": 12 * steps, "sm_loss_sums": steps + 2,
                  "sm_loss_grads": steps, "compat_cache_int8": 2, "fused_encoder_layer": 24,
                  "seed_knn_exact": steps + 2, "seed_inlier_counts": steps + 2}
        for name, count in counts.items():
            check(count == expect.get(name, 0),
                  f"trainer: {name} launched {count} times, expected {expect.get(name, 0)}")

        # 18. the checkpoint through load_pretrained and register
        model = pt.load_pretrained(tmp, device=DEVICE)
        for key, value in state.model.state_dict().items():
            check(torch.equal(value, model.state_dict()[key]), f"checkpoint: {key} differs")
        p = SyntheticPairDataset(num_pairs=1, num_corr=TRAIN_N, inlier_ratio=0.35, seed=5)[0]
        out = pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"], model=model,
                          device=DEVICE)
        check(out.final_trans.shape == (1, 4, 4) and bool(torch.isfinite(out.final_trans).all())
              and out.final_labels.shape == (1, TRAIN_N), "checkpoint: bad registration output")
        print(f"checkpoint {os.path.basename(path)} ({os.path.getsize(path)} bytes): loaded by "
              "load_pretrained, state dict equal, register gives a finite transform", flush=True)
    del trainer, state, model
    torch.cuda.empty_cache()

    # 16. ms per step, peak memory and launches per step, fused and dense
    # (host clock around a step that ends in a synchronise; median of 10
    # after 3 warm-ups)
    for fused in (True, False):
        trainer, state = make(fused)
        dev_batch = trainer.to_device(batch)
        for _ in range(3):
            state, _ = trainer.train_step(state, dev_batch, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            state, _ = trainer.train_step(state, dev_batch, 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v / 10 for k, v in kernels.launch_counts().items() if v}
        print(json.dumps({"metric": "train_step_ms", "config": "fused" if fused else "dense",
                          "bs": TRAIN_BS, "n": TRAIN_N, "value": statistics.median(times),
                          "peak_memory_gib": peak_gib(), "launches_per_step": per_step}),
              flush=True)
        del trainer, state
        torch.cuda.empty_cache()

    # 17. the KITTI regime: two fused steps through train_epoch, then one
    # dense step for its memory figure only (an out-of-memory error is a
    # finding, not a failure)
    kitti = dict(num_node=N_KITTI, batch_size=KITTI_BS, inlier_threshold=0.6, sigma_d=1.2,
                 training_max_iter=2)
    ds_k = SyntheticPairDataset(num_pairs=2 * KITTI_BS, num_corr=N_KITTI, inlier_ratio=0.35,
                                seed=17, **KITTI_DATA)
    with tempfile.TemporaryDirectory() as tmp:
        trainer, state = make(True, "KITTI", verbose=True, tboard_dir=tmp, **kitti)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = trainer.train_epoch(Loader(ds_k, KITTI_BS, num_workers=2), state, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer.logger.close()
        with open(trainer.logger.path) as fh:
            events = {e["tag"]: e["value"] for e in map(json.loads, fh)}
    print(json.dumps({"metric": "kitti_regime_fused", "bs": KITTI_BS, "n": N_KITTI, "steps": 2,
                      "mean_loss": events["Train/loss"], "grad_finite": events["Train/grad_finite"],
                      "s_per_step": wall / 2, "peak_memory_gib": peak_gib()}), flush=True)
    check(math.isfinite(events["Train/loss"]) and events["Train/grad_finite"] == 1.0
          and state.step == 2, "the KITTI-regime steps failed")
    del trainer, state
    torch.cuda.empty_cache()
    trainer, state = make(False, "KITTI", **kitti)
    kbatch = trainer.to_device(train_batch(KITTI_BS, N_KITTI, seed=17, **KITTI_DATA))
    torch.cuda.reset_peak_memory_stats()
    try:
        state, metrics = trainer.train_step(state, kbatch, 1)
        torch.cuda.synchronize()
        print(json.dumps({"finding": "kitti_regime_dense", "fits": True,
                          "loss": float(metrics["loss"]), "peak_memory_gib": peak_gib()}),
              flush=True)
    except torch.cuda.OutOfMemoryError:
        print(json.dumps({"finding": "kitti_regime_dense", "fits": False,
                          "peak_memory_gib_before_the_error": peak_gib()}), flush=True)
    del trainer, state, kbatch
    torch.cuda.empty_cache()
    return {name: counts[name] for name in TRAIN_KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        import pointdsc_tpu_torch as pt
        from pointdsc_tpu_torch import kernels
        from pointdsc_tpu_torch._device import full_f32_matmul
        from pointdsc_tpu_torch.data import SyntheticPairDataset
        from pointdsc_tpu_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 3
    dev = torch.device(DEVICE)
    # phases 3 to 13 are eval forwards: no autograd graph (training turns it on again)
    torch.set_grad_enabled(False)

    # 1. the card
    print(card_line(), flush=True)

    # 2. build
    print(f"build_s: {_build.build_all():.3f}", flush=True)

    # 3. kernels against their plain versions (full f32 matmuls, as in the
    # forward); these launches are not the main path's
    with full_f32_matmul():
        rows = check_kernels(torch, dev)
    print("kernels_vs_plain: ok", flush=True)

    # 4. the running-max path: load_pretrained + register, fused
    model = pt.load_pretrained(SNAPSHOT, device=DEVICE, offset_softmax=False)
    shifted = pt.load_pretrained(SNAPSHOT, device=DEVICE, offset_softmax=False)
    ds = SyntheticPairDataset(num_pairs=PAIRS + 1, num_corr=N, inlier_ratio=0.4, seed=0)
    pairs = [ds[i] for i in range(PAIRS + 1)]
    runs = [(model, p) for p in pairs[:PAIRS]] + [(shifted, pairs[PAIRS])]
    torch.cuda.synchronize()
    kernels.reset_launches()
    fused = []
    for i, (m, p) in enumerate(runs):
        if m is shifted:
            # raise the logits by the first pair's lower quartile, so that
            # NMS picks seeds by score (a share of the logits positive)
            with torch.no_grad():
                shifted.classification_2.bias.sub_(torch.quantile(fused[0].confidence, 0.25))
        fused.append(pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"], model=m,
                                 device=DEVICE))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"main_path_launches: {json.dumps(launches)}", flush=True)
    for i, ((m, p), out) in enumerate(zip(runs, fused)):
        tag = f"pair {i}" + (" (raised logits)" if m is shifted else "")
        ft = out.final_trans
        check(ft.shape == (1, 4, 4) and bool(torch.isfinite(ft).all()), f"{tag}: bad final_trans")
        check(out.final_labels.shape == (1, N), f"{tag}: bad final_labels")
        cp, src, tgt = (torch.as_tensor(p[k])[None].to(dev)
                        for k in ("corr_pos", "src_keypts", "tgt_keypts"))
        dense = m(cp, src, tgt, fused=False)
        terr = float((ft - dense.final_trans).abs().max())
        agree = float((out.final_labels == dense.final_labels).float().mean())
        # the dense path's f32 compat moves the logits by up to ~7e-3 from the
        # int8 cache's, which may flip the NMS flag or the rank of near-equal
        # neighbours (measured 0.982-0.994 on the CPU): sets, overlap >= 0.95;
        # seed_checks holds the seeds exactly to the run's own confidences
        overlap = len(set(out.seeds[0].tolist()) & set(dense.seeds[0].tolist())) / S
        print(f"{tag}: fused-vs-dense final_trans max err {terr:.3e}, label agreement "
              f"{agree:.4f}, seed set overlap {overlap:.4f}", flush=True)
        check(terr <= 1e-3 and agree > 0.99, f"{tag}: fused path disagrees with dense")
        check(overlap >= 0.95, f"{tag}: fused seeds disagree with the dense path's")
        seed_checks(torch, out, m, cp, src, tgt, tag)
    check(float((fused[PAIRS].confidence > 0).float().mean()) > 0.2,
          "the raised-logit pair has too few positive confidences")

    # 5. the golden file of the JAX package's dense path. Seeds as sets, for
    # the reason of phase 4 (measured 0.990-0.994 on the card).
    gold = np.load(GOLDEN)
    for i, out in enumerate(fused[:PAIRS]):
        terr = float(np.abs(out.final_trans[0].cpu().numpy() - gold["final_trans"][i]).max())
        agree = float(((out.final_labels[0].cpu().numpy() > 0.5) == gold["final_labels"][i]).mean())
        seeds = set(out.seeds[0].cpu().tolist())
        seed_overlap = len(seeds & set(gold["seeds"][i].tolist())) / len(seeds)
        print(f"pair {i}: vs JAX golden final_trans max err {terr:.3e}, label agreement "
              f"{agree:.4f}, seed set overlap {seed_overlap:.4f}", flush=True)
        check(terr <= 1e-3 and agree > 0.99, f"pair {i}: disagrees with the JAX golden file")
        check(seed_overlap >= 0.98, f"pair {i}: seeds disagree with the JAX golden file")

    # 6. every kernel of the running-max path ran on it, and no other
    missing = [name for name in RUNNING_MAX_KERNELS if launches[name] <= 0]
    check(not missing, f"kernels not launched on the running-max path: {missing}")
    stray = [name for name, count in launches.items()
             if count and name not in RUNNING_MAX_KERNELS]
    check(not stray, f"the running-max path launched {stray}")

    # 7. end-to-end time of the fused forward, one pair
    p = pairs[0]
    fwd_ms = time_ms(lambda: pt.register(p["corr_pos"], p["src_keypts"], p["tgt_keypts"],
                                         model=model, device=DEVICE), reps=10, warmup=2)
    dense_in = [torch.as_tensor(p[k])[None].to(dev) for k in ("corr_pos", "src_keypts",
                                                               "tgt_keypts")]
    dense_ms = time_ms(lambda: model(*dense_in, fused=False), reps=10, warmup=2)
    print(json.dumps({"metric": "fused_forward_ms_per_pair", "config": "running_max", "n": N,
                      "value": fwd_ms, "dense_forward_ms": dense_ms}), flush=True)

    # 8-11. the default configuration, half precision, the guard's flip
    launches.update(default_configuration(torch, pt, kernels, dev))

    # 12-13. the training kernels and the no-cache eval attention against
    # their plain versions; the eval forward without a cache
    torch.set_grad_enabled(True)
    with full_f32_matmul():
        rows += check_train_kernels(torch, dev)
    print("train_kernels_vs_plain: ok", flush=True)
    launches["fused_sc_attention"] = no_cache_forward(torch, pt, kernels, dev)

    # 14-18. training
    launches.update(training(torch, pt, kernels, dev))

    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']} was launched no time on its main path")
        print(json.dumps({"name": row["name"], "launches": row["launches"], "ms": row["ms"]}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
