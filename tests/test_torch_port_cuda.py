"""The port's CUDA kernels, through their public wrappers, against their
plain versions on the card, at ragged sizes and batch 2 (chip_smoke.py holds
them at the main path's N = 5120, batch 1). Every test here needs a CUDA
card and skips without one. On a machine with a card (``--noconftest``: the
suite's conftest imports JAX, which the card's machine need not have):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from pointdsc_tpu_torch import PointDSC, kernels, load_pretrained
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import _check as kchk
from pointdsc_tpu_torch.kernels import conf_mlp as kconf
from pointdsc_tpu_torch.kernels import encoder_layer as kenc
from pointdsc_tpu_torch.kernels import nms as knms
from pointdsc_tpu_torch.kernels import refine as kref
from pointdsc_tpu_torch.kernels import sc_attention as katt
from pointdsc_tpu_torch.kernels import scoring as kscore
from pointdsc_tpu_torch.kernels import seed_knn as kknn
from pointdsc_tpu_torch.kernels import nn_search as knn_s
from pointdsc_tpu_torch.kernels import sm_loss as ksm
from pointdsc_tpu_torch.kernels import symcache as ksym
from pointdsc_tpu_torch.ops import icp as icp_mod

pytestmark = pytest.mark.cuda
SNAP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "snapshot", "PointDSC_Synthetic_release")

B = 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def pair(n, dev, seed=0):
    """B synthetic pairs (40% inliers); the second has its last 10% padded."""
    exs = [SyntheticPairDataset(num_pairs=B, num_corr=n, seed=seed)[i] for i in range(B)]
    src = torch.as_tensor(np.stack([e["src_keypts"] for e in exs])).to(dev)
    tgt = torch.as_tensor(np.stack([e["tgt_keypts"] for e in exs])).to(dev)
    mask = torch.ones((B, n), dtype=torch.bool)
    mask[1, n - n // 10:] = False
    gt = torch.as_tensor(np.stack([e["gt_trans"] for e in exs])).to(dev)
    return src, tgt, mask.to(dev), gt


@pytest.mark.parametrize("n", [1000, 2048, 5120, 12288])
def test_compat_cache(dev, n):
    """+-1 on at most 0.1% of entries: the kernel's FMAs and cuBLAS round the
    gram-form distances differently, so an entry near a .5 boundary may round
    either way. N = 1000 takes the guarded stores of a ragged edge."""
    src, tgt, mask, _ = pair(n, dev)
    plain = katt.compat_cache_plain(katt.pack_geometry(src, tgt, mask), katt.cache_coef(0.1))
    diff = (katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask).int() - plain.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 1).float().mean()) <= 1e-3


@pytest.mark.parametrize("n,tail", [(1000, "tenth"), (2048, "tenth"), (5120, "tenth"),
                                    (12288, "tenth"), (12289, "tenth"), (20480, "tenth"),
                                    (4096, "split")])
def test_sc_attention(dev, n, tail):
    """The running-max kernel on the same cache, ragged (N = 1000, and 12289:
    not a multiple of the 128-row tiles, nor of the 16 bytes TMA takes, so the
    producer stages the compat bytes) and with masked keys: the second pair's
    last 10% ("tenth"), or ("split") its keys from the start of a split that
    the plan gives a block whole, so that split's (m, l, acc) must merge with
    weight exactly 0. The sizes of the cells (12288, 20480) and of 3DMatch
    (5120) split query tiles across blocks. It takes bf16 q, k, v and rounds
    p to bf16 before p v, as the JAX wrapper and the TPU kernel do off the
    CPU, so it is held to the plain version of the bf16 inputs at the offset
    kernel's atol = rtol = 2e-3 (was 1e-4 while it ran f32): a p on a bf16
    rounding boundary may round either way (the kernel rounds p against each
    tile's running max, the plain version against the row's maximum), each
    flip moving one of ~n terms by 2^-9 relative. f32 inputs are rounded by
    the wrapper: the bf16 inputs' result bit for bit. Masked keys carry
    exactly zero weight: v = 1e6 on them changes nothing."""
    src, tgt, mask, _ = pair(n, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = katt.cached_attention_plan(B, n, sms)
    first_masked = n - n // 10
    if tail == "split":
        # the second sample's split items that end at the last key tile
        keys = -(-n // katt.ATTN_KEYS)
        tails = [it for it in plan.items if it[0] == 1 and it[4] >= 0 and it[2] > 0
                 and it[2] + it[3] == keys]
        assert tails, "the plan has no split to mask"
        first_masked = max(it[2] for it in tails) * katt.ATTN_KEYS
        mask = torch.ones((B, n), dtype=torch.bool, device=dev)
        mask[1, first_masked:] = False
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((B, n, 128), generator=gen).to(dev) for _ in range(3))
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    geom = katt.pack_geometry(src, tgt, mask)
    cache = katt.compat_cache_plain(geom, katt.cache_coef(0.1))
    out = katt.fused_sc_attention_cached(qh, kh, vh, cache, src, tgt, mask=mask,
                                         offset_softmax=False)
    assert katt.fused_sc_attention_cached.plan == plan
    ref = katt.sc_attention_cached_plain(qh, kh, vh, cache, geom[:, 8].contiguous())
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)
    assert torch.equal(katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                                      offset_softmax=False), out)
    v2 = vh.clone()
    v2[1, first_masked:] = 1e6
    out2 = katt.fused_sc_attention_cached(qh, kh, v2, cache, src, tgt, mask=mask,
                                          offset_softmax=False)
    assert torch.equal(out2, out)


@pytest.mark.parametrize("n", [1000, 12288])
def test_sc_attention_growing_maxima(dev, n):
    """Row maxima that grow with the key index, so that every key tile of the
    kernel (ATTN_KEYS keys) raises the running max and rescales the
    accumulator (alpha < 1 in each tile): a full cache, q_i = 4 u + noise and
    k_j = (40 * 64 / ATTN_KEYS) (j / 1000) u + noise for a unit u, so the
    logits rise by ~0.9 nats a tile. At N = 12288 the plan splits the query
    tiles' keys, so the merge meets the same rising maxima. Tolerance as
    ``test_sc_attention``."""
    src, tgt, mask, _ = pair(n, dev)
    gen = torch.Generator().manual_seed(2)
    u = torch.nn.functional.normalize(torch.randn(128, generator=gen), dim=0)
    ramp = 40.0 * 64 / katt.ATTN_KEYS * torch.arange(n, dtype=torch.float32)[:, None] / 1000
    q = 4.0 * u + 0.1 * torch.randn((B, n, 128), generator=gen)
    k = ramp * u + 0.1 * torch.randn((B, n, 128), generator=gen)
    v = torch.randn((B, n, 128), generator=gen)
    q, k, v = (t.to(dev).bfloat16() for t in (q, k, v))
    cache = torch.full((B, n, n), 127, dtype=torch.int8, device=dev)
    out = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                         offset_softmax=False)
    bias = katt.key_bias(mask, B, n, dev)
    ref = katt.sc_attention_cached_plain(q, k, v, cache, bias)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)
    # the premise: each tile's largest logit exceeds every earlier tile's
    s = torch.einsum("bnc,bmc->bnm", q.float(), k.float()) * katt.qk_scale(128) + bias[:, None]
    n_valid = n - n // 10  # the second pair's keys past it are masked
    width = katt.ATTN_KEYS
    tiles = s[:, :, :n_valid - n_valid % width].unflatten(-1, (-1, width)).amax(-1)
    assert bool((tiles[..., 1:] > tiles[..., :-1]).all())


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("n", [1000, 2048])
def test_sc_attention_offset(dev, n, half):
    """The offset kernel on the same cache. It takes bf16 q, k, v and rounds p
    to bf16 before p v; a p whose f32 value sits on a rounding boundary may
    round either way in the two versions (the exponent's argument differs in
    its last bit), each such flip moving one of ~n terms by 2^-9 relative:
    atol = rtol = 2e-3. On the card the wrapper rounds f32 inputs to bf16, so
    they are held against the plain version of the rounded inputs."""
    src, tgt, mask, _ = pair(n, dev)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((B, n, 128), generator=gen).to(dev) for _ in range(3))
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    if half:
        q, k, v = qh, kh, vh
    geom = katt.pack_geometry(src, tgt, mask)
    cache = katt.compat_cache_plain(geom, katt.cache_coef(0.1))
    out = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask)
    ref = katt.sc_attention_cached_offset_plain(qh, kh, vh, cache, geom[:, 8].contiguous())
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)
    # padded keys carry exactly zero weight: garbage in their v rows changes nothing
    v2 = v.clone()
    v2[1, n - n // 10:] = 1e6
    out2 = katt.fused_sc_attention_cached(q, k, v2, cache, src, tgt, mask=mask)
    assert torch.equal(out2, out)


def layer_weights(gen, dev, c=128):
    """Folded weights of one C-wide layer from ``gen``. The q and k
    projections are scaled so that the logits have a standard deviation of
    ~3 (a sharp softmax, offsets near 40 nats: in regime)."""

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def bn(ch):
        return (1.0 + rnd(ch, scale=0.1), rnd(ch, scale=0.1), rnd(ch, scale=0.1),
                1.0 + rnd(ch, scale=0.1).abs())

    s, qk = c ** -0.5, (3.0 / 64.0) ** 0.5
    pcn = (rnd(c, c, scale=s), rnd(c, scale=0.1), bn(c))
    nl = (rnd(c, c, scale=qk), rnd(c, scale=0.1), rnd(c, c, scale=qk), rnd(c, scale=0.1),
          rnd(c, c, scale=s), rnd(c, scale=0.1), rnd(c // 2, c, scale=s), rnd(c // 2, scale=0.1),
          bn(c // 2), rnd(c // 2, c // 2, scale=s), rnd(c // 2, scale=0.1), bn(c // 2),
          rnd(c, c // 2, scale=s), rnd(c, scale=0.1))
    return kenc.fold_layer(pcn, nl)


def layer_case(n, dev, masked, seed=3, c=128):
    """x, cache, kbias and folded weights of one C-wide layer, B = 2."""
    src, tgt, mask, _ = pair(n, dev)
    gen = torch.Generator().manual_seed(seed)
    weights = layer_weights(gen, dev, c)
    x = (torch.randn((B, n, c), generator=gen)).to(dev)
    cache = katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    kbias = katt.key_bias(mask, B, n, dev) if masked else None
    return x, cache, kbias, weights


def pcn_case(n, dev, seed=3, c=128):
    """x [B, n, C] and folded weights; the second sample's last 10% of rows
    are padding (zeros, as the model's padded correspondences give)."""
    gen = torch.Generator().manual_seed(seed)
    weights = layer_weights(gen, dev, c)
    x = torch.randn((B, n, c), generator=gen)
    x[1, n - n // 10:] = 0.0
    return x.to(dev), weights


def assert_bf16_equal_but_boundaries(got, want, max_share=1e-3):
    """bf16 arrays equal bit for bit except where the f32 pre-image sat on a
    rounding boundary (the two versions sum 128 products in another order):
    those differ by one bf16 step."""
    diff = (got.float() - want.float()).abs()
    step = want.float().abs().clamp_min(1e-30) * 2.0 ** -7
    assert bool((diff <= step).all())
    assert float((diff > 0).float().mean()) <= max_share


def assert_pcn_qkv_close(got, ref):
    h, q, k, v, kscale = got
    hp, qp, kp, vp, ksp = ref
    torch.testing.assert_close(h, hp, atol=1e-5, rtol=1e-5)
    for g, want in ((q, qp), (k, kp), (v, vp)):
        assert_bf16_equal_but_boundaries(g, want)
    torch.testing.assert_close(kscale, ksp, atol=0, rtol=1e-5)


@pytest.mark.parametrize("n", [512, 1024, 6145, 12288, 20480])
def test_pcn_qkv(dev, n):
    """h atol = rtol = 1e-5 (f32 dot products of 128 terms in another order);
    q, k, v equal in bf16 except at rounding boundaries (<= 0.1% of entries,
    by one step); kscale rtol 1e-5. Batch 2 with padded rows; N = 6145 ends
    in a tail tile of one row."""
    x, weights = pcn_case(n, dev)
    assert_pcn_qkv_close(kenc.pcn_qkv(x, weights), kenc.pcn_qkv_plain(x, weights))


def test_pcn_qkv_workspace(dev):
    """A workspace written twice (two inputs in a row, as the layers of a
    forward) holds the second input's results, equal bit for bit to fresh
    tensors, at N = 6145 (a tail tile)."""
    x, weights = pcn_case(6145, dev)
    ws = kenc.new_workspace(B, 6145, 128, dev)
    kenc.pcn_qkv(2.0 * x, weights, ws)
    got = kenc.pcn_qkv(x, weights, ws)
    assert all(g is w for g, w in zip(got, ws))
    for g, fresh in zip(got, kenc.pcn_qkv(x, weights)):
        assert torch.equal(g, fresh)


def test_pcn_qkv_is_the_one_launch_phase(dev):
    """The split kernel sums as the one-launch kernel's first phase does: its
    h, q, k, v and kscale equal that phase's (read from the workspace the
    one-launch kernel was given) bit for bit."""
    x, cache, kbias, weights = layer_case(1024, dev, True)
    ws = kenc.new_workspace(B, 1024, 128, dev)
    kenc.fused_encoder_layer(x, cache, kbias, weights, ws)
    for got, want in zip(kenc.pcn_qkv(x, weights), ws):
        assert torch.equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [512, 1024])
def test_attn_mlp_residual(dev, n, masked):
    """On the plain version's own h, q, k, v, kscale: atol = rtol = 2e-3 (p
    rounded to bf16 may round either way at a boundary, see
    test_sc_attention_offset; the MLP is f32)."""
    x, cache, kbias, weights = layer_case(n, dev, masked)
    h, q, k, v, kscale = kenc.pcn_qkv_plain(x, weights)
    out = kenc.attn_mlp_residual(kscale, q, k, v, cache, kbias, h, weights)
    ref = kenc.attn_mlp_residual_plain(kscale, q, k, v, cache, kbias, h, weights)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [512, 1024])
def test_fused_encoder_layer(dev, n, masked):
    """The one-launch kernel against its plain version and against the pair of
    kernels (atol = rtol = 2e-3: a q, k or v that rounds the other way in
    bf16 moves a logit by ~2^-9 relative), twice, so that the zeroing of
    kscale before each launch is exercised."""
    x, cache, kbias, weights = layer_case(n, dev, masked)
    ref = kenc.fused_layer_plain(x, cache, kbias, weights)
    for _ in range(2):
        out = kenc.fused_encoder_layer(x, cache, kbias, weights)
        torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)
    h, q, k, v, kscale = kenc.pcn_qkv(x, weights)
    pair_out = kenc.attn_mlp_residual(kscale, q, k, v, cache, kbias, h, weights)
    torch.testing.assert_close(out, pair_out, atol=1e-5, rtol=1e-5)


def test_new_wrappers_refuse(dev):
    """Wrong dtype, a width that fits neither the weights nor the input, an
    N the encoder-layer kernels do not take, a workspace of the wrong shape.
    A width above 128 is not refused: it runs, held to the plain version."""
    x, cache, kbias, weights = layer_case(512, dev, True)
    with pytest.raises(ValueError):
        kenc.fused_encoder_layer(x.double(), cache, kbias, weights)
    with pytest.raises(ValueError):
        kenc.fused_encoder_layer(x[:, :500].contiguous(), cache[:, :500, :500].contiguous(),
                                 kbias[:, :500].contiguous(), weights)
    with pytest.raises(ValueError):
        kenc.pcn_qkv(x, weights, kenc.new_workspace(B, 500, 128, dev))
    with pytest.raises(ValueError):
        kenc.pcn_qkv(x[..., :64].contiguous(), weights)
    h, q, k, v, kscale = kenc.pcn_qkv(x, weights)
    with pytest.raises(ValueError):
        kenc.attn_mlp_residual(kscale, q.float(), k, v, cache, kbias, h, weights)
    with pytest.raises(ValueError):
        kenc.attn_mlp_residual(kscale, q, k, v, cache.float(), kbias, h, weights)
    src, tgt, mask, _ = pair(512, dev)
    wide = torch.randn((B, 512, 192), generator=torch.Generator().manual_seed(2)).to(dev)
    out = katt.fused_sc_attention_cached(wide, wide, wide, cache, src, tgt, mask=mask)
    wh = wide.bfloat16()
    kb = katt.key_bias(mask, B, 512, dev)
    ref = katt.sc_attention_cached_offset_plain(wh, wh, wh, cache, kb)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)
    with pytest.raises(ValueError):
        katt.fused_sc_attention_cached(x.half(), x.half(), x.half(), cache, src, tgt, mask=mask)


def head_weights(gen, dev):
    return [torch.randn(shape, generator=gen).to(dev) * 0.2
            for shape in ((32, 128), (32,), (32, 32), (32,), (1, 32), (1,))]


@pytest.mark.parametrize("n", [1000, 2048])
def test_confidence_head(dev, n):
    """atol = rtol = 1e-5: f32 dot products of 128 and 32 terms summed in
    another order than cuBLAS's."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((B, n, 128), generator=gen).to(dev)
    w = head_weights(gen, dev)
    torch.testing.assert_close(kconf.confidence_head(x, kconf.pack_head_weights(*w)),
                               kconf.confidence_head_plain(x, *w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 31, 5120, 12288, 20480])
def test_confidence_head_rows(dev, m):
    """One row, a ragged tile, and the main path's sizes (20480: more tiles
    than one wave of blocks, so that blocks walk several tiles through both
    feature buffers), atol 1e-5; a second call on the same packed weights
    gives the same logits bit for bit."""
    gen = torch.Generator().manual_seed(m)
    x = torch.randn((1, m, 128), generator=gen).to(dev)
    w = head_weights(gen, dev)
    packed = kconf.pack_head_weights(*w)
    out = kconf.confidence_head(x, packed)
    assert out.shape == (1, m)
    torch.testing.assert_close(out, kconf.confidence_head_plain(x, *w), atol=1e-5, rtol=0)
    assert torch.equal(kconf.confidence_head(x, packed), out)


def test_packed_head_weights_follow_the_model(dev):
    """The model's packed head is reused while its weights stay, and packed
    anew after an in-place change (an optimizer step's kind)."""
    model = PointDSC(num_layers=1, device=dev, generator=torch.Generator().manual_seed(0))
    head = [t for layer in (model.classification_0, model.classification_1,
                            model.classification_2) for t in (layer.weight, layer.bias)]
    first = kconf.packed_head_weights(head, model._head_cache)
    assert kconf.packed_head_weights(head, model._head_cache) is first
    with torch.no_grad():
        model.classification_2.bias.add_(1.0)
    second = kconf.packed_head_weights(head, model._head_cache)
    assert second is not first and float(second[-4] - first[-4]) == 1.0  # b2


@pytest.mark.parametrize("n", [1000, 2048])
def test_nms_flags(dev, n):
    """Equal to the plain version bit for bit: both round each product and
    sum of d2 and of the squared norms on its own, in one order."""
    src, _, mask, _ = pair(n, dev)
    scores = torch.randn((B, n), generator=torch.Generator().manual_seed(2)).to(dev)
    flags = knms.nms_local_max(src, scores, 0.1, mask=mask)
    assert torch.equal(flags, knms.nms_local_max_plain(src, scores, mask, knms.radius_sq(0.1)))
    assert 0 < float(flags.sum()) < B * n


def device_operations(fn) -> int:
    """The device operations (kernels, copies, sets) of one call of fn: the
    nodes of a CUDA graph that captures it, after one call outside the
    capture. torch.profiler gave the same counts, but now and then a session
    lost all its device events, most often in a fresh process (C14)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    assert err == 0, f"cuGraphGetNodes failed with CUresult {err}"
    return count.value


def nms_case(n, case, dev):
    """B = 2 clouds in the cube [-1, 1]^3 (the second's last 10% padded),
    scores and radius chosen for one branch of the prefilter at N >= 12288:
    ``certificate`` (positive scores, radius 0.05: enough local maxima in the
    top M), ``mixed_signs`` (normal scores: suppressed points at +0.0 and
    -0.0), ``scarce_maxima`` (the cloud shrunk into a 0.02 cube, radius 0.2:
    one local maximum, S above the positive keys, +0.0 ties to the index) and
    ``all_negative`` (the precheck fails: -0.0 ties)."""
    rng = np.random.default_rng(n + len(case))
    src = rng.uniform(-1.0, 1.0, size=(B, n, 3))
    radius = 0.05
    if case == "scarce_maxima":
        src, radius = src * 0.01, 0.2
    if case == "mixed_signs":
        scores = rng.normal(size=(B, n))
    else:
        scores = rng.uniform(0.01, 1.0, size=(B, n)) * (-1.0 if case == "all_negative" else 1.0)
    mask = np.ones((B, n), bool)
    mask[1, n - n // 10:] = False
    return (torch.as_tensor(src, dtype=torch.float32).to(dev),
            torch.as_tensor(scores, dtype=torch.float32).to(dev), radius,
            torch.as_tensor(mask).to(dev))


@pytest.mark.parametrize("case", ["certificate", "mixed_signs", "scarce_maxima", "all_negative"])
@pytest.mark.parametrize("n", [1000, 5120, 12288, 20480])
def test_pick_seeds_nms(dev, n, case):
    """The card's seeds (the flags-and-key, select and top-M kernels, the
    prefilter's decisions on the device) equal the plain path's indices
    exactly: the CPU path on the same inputs, the gates read on the host.
    The flags' d2 is rounded alike in both. S = N / 10; the prefilter runs
    from N = 12288, where the card's precheck and certificate equal the
    CPU's and each case takes its branch."""
    src, scores, radius, mask = nms_case(n, case, dev)
    s = n // 10
    out = knms.pick_seeds_nms_prefiltered(src, scores, radius, s, mask=mask)
    ref = knms.pick_seeds_nms_prefiltered(src.cpu(), scores.cpu(), radius, s, mask=mask.cpu())
    assert torch.equal(out.cpu(), ref)
    if n >= 12288:
        m = -(-max(4 * s, 4096) // 1024) * 1024
        _, pre_ok, cert = knms.pick_seeds_gated(src, scores, radius, s, mask, m)
        _, pre_ref, cert_ref = knms.pick_seeds_gated(src.cpu(), scores.cpu(), radius, s,
                                                     mask.cpu(), m)
        assert torch.equal(pre_ok.cpu(), pre_ref) and torch.equal(cert.cpu(), cert_ref)
        want = {"certificate": (True, True), "mixed_signs": (True, True),
                "scarce_maxima": (True, False), "all_negative": (False, False)}[case]
        assert (bool(pre_ok.all()), bool(cert.all())) == want


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 1000), (5120, 512), (12288, 1228),
                                 (40000, 4000), (20480, 8192), (12288, 9000), (40000, 20000)])
def test_nms_select_ties(dev, n, k):
    """The select kernel against top_k_like_jax on keys with many ties
    (values from {-inf, -1, -0.0, +0.0, 0.5, 1}; +0.0 above -0.0, ties to
    the lower index), also on rows too long to stage (N = 40000), at the
    largest k sorted in shared memory (8192) and above it (9000, 20000: the
    winners sorted in a workspace in device memory); through a subset, the
    positions map to its indices."""
    from pointdsc_tpu_torch.ops.nms import _total_order_key, top_k_like_jax

    rng = np.random.default_rng(k)
    vals = np.array([-np.inf, -1.0, -0.0, 0.0, 0.5, 1.0], np.float32)
    x = torch.as_tensor(vals[rng.integers(0, len(vals), size=(B, n))]).to(dev)
    keys = _total_order_key(x)
    got = knms.nms_select(keys, k)
    assert torch.equal(got, top_k_like_jax(x, k))
    subset = torch.as_tensor(np.sort(rng.choice(3 * n, size=(B, n)), axis=1).astype(np.int32))
    subset = subset.to(dev)
    got = knms.nms_select(keys, k, subset=subset)
    assert torch.equal(got, torch.gather(subset.long(), 1, top_k_like_jax(x, k)))


def test_pick_seeds_gated_beyond_8192_seeds(dev):
    """The prefiltered selection with S = 9000 > 8192 (both selects sort in
    the workspace that ``pick_seeds_gated`` allocates) equals the CPU path
    exactly, in the branch the data takes, and makes no host sync."""
    n, s, m = 20480, 9000, 9216
    src, scores, radius, mask = nms_case(n, "certificate", dev)
    seeds, pre_ok, cert = knms.pick_seeds_gated(src, scores, radius, s, mask, m)
    ref, pre_ref, cert_ref = knms.pick_seeds_gated(src.cpu(), scores.cpu(), radius, s,
                                                   mask.cpu(), m)
    assert torch.equal(seeds.cpu(), ref)
    assert torch.equal(pre_ok.cpu(), pre_ref) and torch.equal(cert.cpu(), cert_ref)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        knms.pick_seeds_gated(src, scores, radius, s, mask, m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,m", [(12288, 5120), (20480, 8192), (40000, 8192)])
def test_nms_top_m(dev, n, m):
    """The prefilter's select equals its plain version (indices in index
    order, tau, the precheck) on scores with ties and a masked tail."""
    rng = np.random.default_rng(n)
    scores = torch.as_tensor(rng.integers(-3, 6, size=(B, n)).astype(np.float32) / 4).to(dev)
    mask = torch.ones((B, n), dtype=torch.bool, device=dev)
    mask[1, n - n // 10:] = False
    for s_need in (1, m // 2, m):
        got = knms.nms_top_m(scores, mask, m, s_need)
        ref = knms.nms_top_m_plain(scores, mask, m, s_need)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [5120, 12288])
def test_seed_nms_and_cache_make_no_host_sync(dev, n):
    """Both wrappers run under set_sync_debug_mode("error"), the seed NMS at
    N = 12288 through the prefilter's five gated launches."""
    src, scores, radius, mask = nms_case(n, "certificate", dev)
    tgt = src.flip(-1).contiguous()
    knms.pick_seeds_nms_prefiltered(src, scores, radius, n // 10, mask=mask)  # built, warm
    katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        knms.pick_seeds_nms_prefiltered(src, scores, radius, n // 10, mask=mask)
        katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_seed_nms_and_cache_device_operations(dev):
    """The cache build is one device operation a call; the seed NMS two at
    N = 5120 (flags and keys, select) and five at 12288 (the prefilter's
    gated launches), whichever branch the data takes."""
    src, tgt, mask, _ = pair(5120, dev)
    assert device_operations(lambda: katt.build_compat_cache_int8(src, tgt, 0.1,
                                                                  mask=mask)) == 1
    for n, ops in ((5120, 2), (12288, 5)):
        for case in ("certificate", "all_negative"):
            src, scores, radius, mask = nms_case(n, case, dev)
            assert device_operations(lambda: knms.pick_seeds_nms_prefiltered(
                src, scores, radius, n // 10, mask=mask)) == ops


def knn_sets_agree(idx, ref, sim, k):
    """Per seed, the two index sets agree except for candidates whose
    similarity lies within 1e-5 of the k-th largest (a near tie that the two
    summation orders may break either way)."""
    kth = torch.gather(sim, -1, ref[..., k - 1:k])
    for got in (idx, ref):
        other = ref if got is idx else idx
        missing = ~(got[..., :, None] == other[..., None, :]).any(-1)
        vals = torch.gather(sim, -1, got)
        if bool((missing & ((vals - kth).abs() >= 1e-5)).any()):
            return False
    return True


@pytest.mark.parametrize("n", [1000, 2048, 5120, 12288])
def test_seed_knn(dev, n):
    """The kernel's neighbour sets against the plain sort, near ties aside,
    S = n // 10 (the main path's 512 at 5120, 1228 at 12288; neither 100,
    204 nor 1228 is a multiple of the 64-seed tile), the second pair's last
    10% padded."""
    gen = torch.Generator().manual_seed(6)
    f = torch.nn.functional.normalize(torch.randn((B, n, 128), generator=gen), dim=-1).to(dev)
    seeds = torch.stack([torch.randperm(n, generator=gen)[: n // 10] for _ in range(B)]).to(dev)
    _, _, mask, _ = pair(n, dev)
    k = 40
    idx = kknn.seed_knn_exact(f, seeds, k, mask=mask)
    bias = kknn.knn_bias(mask, f)
    ref = kknn.seed_knn_plain(f, seeds, k, bias)
    sf = torch.gather(f, 1, seeds[..., None].expand(-1, -1, 128))
    sim = torch.einsum("bsc,bnc->bsn", sf, f)
    assert knn_sets_agree(idx, ref, sim, k)
    assert bool(torch.gather(mask[:, None].expand(-1, seeds.shape[1], -1), 2, idx).all())
    assert not bool((idx == seeds[..., None]).any())


@pytest.mark.parametrize("case", ["ties", "fewer_than_k"])
def test_seed_knn_exact_cases(dev, case):
    """Index for index against the plain sort where no rounding can break a
    tie: one-hot rows over four channels (every similarity exactly 0 or 1,
    most candidates tied: ties in index order), and 24 valid points of 4096
    with k = 40 (the padded ones fill in index order, never a seed itself;
    one seed is a padded point)."""
    n, k = 4096, 40
    gen = torch.Generator().manual_seed(8)
    if case == "ties":
        f = torch.zeros((B, n, 128))
        f[torch.arange(B)[:, None], torch.arange(n), torch.randint(0, 4, (B, n), generator=gen)] = 1
        mask = torch.ones((B, n), dtype=torch.bool)
        mask[1, n - n // 10:] = False
        seeds = torch.stack([torch.randperm(n, generator=gen)[: n // 10] for _ in range(B)])
    else:
        f = torch.nn.functional.normalize(torch.randn((B, n, 128), generator=gen), dim=-1)
        mask = torch.zeros((B, n), dtype=torch.bool)
        valid = torch.stack([torch.randperm(n, generator=gen)[:24] for _ in range(B)])
        mask[torch.arange(B)[:, None], valid] = True
        seeds = torch.cat([valid[:, :8], (~mask).int().argmax(-1, keepdim=True)], dim=1)
    f, mask, seeds = f.to(dev), mask.to(dev), seeds.to(dev)
    idx = kknn.seed_knn_exact(f, seeds, k, mask=mask)
    ref = kknn.seed_knn_plain(f, seeds, k, kknn.knn_bias(mask, f))
    assert torch.equal(idx, ref)
    assert not bool((idx == seeds[..., None]).any())


def test_seed_knn_long_rows(dev):
    """Rows too long for the selection to stage in shared memory (N = 45056,
    past its 40960 keys: the keys are read from the scratch on every pass):
    sets against the plain sort, near ties aside."""
    n, s, k = 45056, 16, 40
    gen = torch.Generator().manual_seed(10)
    f = torch.nn.functional.normalize(torch.randn((B, n, 128), generator=gen), dim=-1).to(dev)
    seeds = torch.stack([torch.randperm(n, generator=gen)[:s] for _ in range(B)]).to(dev)
    _, _, mask, _ = pair(n, dev)
    idx = kknn.seed_knn_exact(f, seeds, k, mask=mask)
    ref = kknn.seed_knn_plain(f, seeds, k, kknn.knn_bias(mask, f))
    sim = torch.einsum("bsc,bnc->bsn", torch.gather(f, 1, seeds[..., None].expand(-1, -1, 128)), f)
    assert knn_sets_agree(idx, ref, sim, k)
    assert bool(torch.gather(mask[:, None].expand(-1, s, -1), 2, idx).all())
    assert not bool((idx == seeds[..., None]).any())


@pytest.mark.parametrize("s", [1, 63, 65, 130])
def test_seed_knn_seed_tail(dev, s):
    """S not a multiple of the 64-seed tile: the tail tile's rows are masked,
    not repeated, and every seed gets its own list (sets against the plain
    sort, near ties aside)."""
    n, k = 2048, 40
    gen = torch.Generator().manual_seed(9)
    f = torch.nn.functional.normalize(torch.randn((B, n, 128), generator=gen), dim=-1).to(dev)
    seeds = torch.stack([torch.randperm(n, generator=gen)[:s] for _ in range(B)]).to(dev)
    _, _, mask, _ = pair(n, dev)
    idx = kknn.seed_knn_exact(f, seeds, k, mask=mask)
    ref = kknn.seed_knn_plain(f, seeds, k, kknn.knn_bias(mask, f))
    sim = torch.einsum("bsc,bnc->bsn", torch.gather(f, 1, seeds[..., None].expand(-1, -1, 128)), f)
    assert idx.shape == (B, s, k)
    assert knn_sets_agree(idx, ref, sim, k)
    assert not bool((idx == seeds[..., None]).any())


@pytest.mark.parametrize("n", [1000, 2048])
def test_seed_inlier_counts(dev, n):
    """Per seed, |count - plain| <= the points whose squared residual lies
    within 1e-5 of tau^2 (FMA rounding)."""
    src, tgt, mask, gt = pair(n, dev)
    s = n // 10
    gen = torch.Generator().manual_seed(3)
    trans = gt[:, None].expand(B, s, 4, 4).clone()
    trans[:, :, :3, 3] += 0.05 * torch.randn((B, s, 3), generator=gen).to(dev)
    t2 = kscore.thr_sq(0.1)
    counts = kscore.seed_inlier_counts(trans, src, tgt, 0.1, mask=mask)
    ref = kscore.seed_inlier_counts_plain(trans, src, tgt, t2, mask)
    pred = torch.einsum("bsij,bnj->bsni", trans[:, :, :3, :3], src) + trans[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    near = torch.sum(((res2 - t2).abs() < 1e-5) & mask[:, None, :], dim=-1)
    assert bool(torch.all((counts - ref).abs() <= near))
    assert float(counts.sum()) > 0


def hypothesis_case(n, dev, kitti=False):
    """The seed stage's arguments for B pairs of n points
    (``data.synthetic.seed_stage_inputs``: half inliers, seeds among the
    valid inliers, the last 10% of each sample padded; C = 128, k = 40,
    sigma 0.8), the neighbours from the seed k-NN kernel."""
    from pointdsc_tpu_torch.data.synthetic import seed_stage_inputs

    d = seed_stage_inputs(n, batch=B, kitti=kitti, pad_fraction=0.1)
    f, seeds, src, tgt, mask = (torch.as_tensor(d[k]).to(dev)
                                for k in ("feats", "seeds", "src", "tgt", "mask"))
    knn = kknn.seed_knn_exact(f, seeds, 40, mask=mask)
    return (f, seeds, knn, src, tgt, mask, torch.full((1,), 0.8, device=dev), d["sigma_d"],
            d["inlier_threshold"], 10)


@pytest.mark.parametrize("kitti", [False, True])
@pytest.mark.parametrize("n", [5120, 12288])
def test_seed_hypotheses(dev, n, kitti):
    """The seed stage's three kernels against their plain versions: seed_trans
    atol 1e-4 in the unit cube, 1e-3 at the KITTI scale (translations of
    tens of metres; sums of another order); the counts equal an [S, N] count
    of the kernel's own transforms but for points within 1e-5 of tau^2 (FMA
    rounding); final_trans the plain's where the argmax is the same seed,
    else a tie of equal fitness moved it; the labels the plain labels of the
    kernel's own final_trans, but for points within 1e-5 of tau."""
    args = hypothesis_case(n, dev, kitti)
    feats, seeds, knn, src, tgt, mask, sigma, sigma_d, thr, iters = args
    kernels.reset_launches()
    seed_trans, fitness, final_trans, labels = kscore.seed_hypotheses(*args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["seed_hypotheses"], counts["seed_inlier_counts"],
            counts["select_hypothesis"]) == (1, 1, 1)
    ref = kscore.seed_hypotheses_plain(*args)
    torch.testing.assert_close(seed_trans, ref[0], atol=1e-3 if kitti else 1e-4, rtol=0)
    t2 = kscore.thr_sq(thr)
    own = kscore.seed_inlier_counts_plain(seed_trans, src, tgt, t2, mask)
    pred = torch.einsum("bsij,bnj->bsni", seed_trans[:, :, :3, :3], src) \
        + seed_trans[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    near = torch.sum(((res2 - t2).abs() < 1e-5 * max(1.0, t2)) & mask[:, None, :], dim=-1)
    denom = mask.sum(-1, keepdim=True).float()
    assert bool(torch.all((fitness * denom - own).abs() <= near + 1e-2))
    assert float(fitness.max()) > 0.1
    best, best_ref = torch.argmax(fitness, -1), torch.argmax(ref[1], -1)
    for b in range(B):
        if int(best[b]) == int(best_ref[b]):
            torch.testing.assert_close(final_trans[b], ref[2][b], atol=1e-3 if kitti else 1e-4,
                                       rtol=0)
        else:
            assert float(fitness[b, best[b]]) == float(fitness[b, best_ref[b]])
        assert torch.equal(final_trans[b], seed_trans[b, best[b]])
    dist = torch.linalg.norm(src @ final_trans[:, :3, :3].transpose(1, 2)
                             + final_trans[:, None, :3, 3] - tgt, dim=-1)
    labels_own = ((dist < thr) & mask).float()
    off = (labels != labels_own) & ((dist - thr).abs() >= 1e-5 * max(1.0, thr))
    assert not bool(off.any())


def test_seed_hypotheses_make_no_host_sync(dev):
    """Three device operations, and no host sync, for the whole seed stage
    after the seed k-NN."""
    args = hypothesis_case(5120, dev)
    kscore.seed_hypotheses(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kscore.seed_hypotheses(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert device_operations(lambda: kscore.seed_hypotheses(*args)) == 3


@pytest.mark.parametrize("k", [1, 16, 128])
def test_seed_hypotheses_any_k(dev, k):
    """k from 1 to the kernel's 128 (a thread a neighbour; 134 KB of shared
    memory at k = C = 128), at batch 2, against the plain version."""
    feats, seeds, _, src, tgt, mask, sigma, sigma_d, thr, iters = hypothesis_case(2048, dev)
    knn = kknn.seed_knn_exact(feats, seeds, k, mask=mask)
    args = (feats, seeds, knn, src, tgt, mask, sigma, sigma_d, thr, iters)
    out = kscore.seed_hypotheses(*args)
    ref = kscore.seed_hypotheses_plain(*args)
    if k >= 3:  # fewer than three points fit no rotation: both take Horn's degenerate branch
        torch.testing.assert_close(out[0], ref[0], atol=1e-4, rtol=0)
    assert bool(torch.isfinite(out[0]).all())


@pytest.mark.parametrize("snapshot,n", [("Synthetic", 5120), ("SyntheticKITTI", 12288)])
def test_seed_hypotheses_on_real_seeds_against_f64(dev, snapshot, n):
    """The seed transforms of a real fused forward (the trained snapshot at
    batch 2 on pairs of its scale: sample 0 with its last 5% masked, sample
    1 with only its first 36 points valid, so that the NMS seeds hold
    outliers and masked points with fewer than k = 40 valid neighbours), made
    by the hypotheses kernel inside the forward, against the f64 plain
    version on the forward's own features, seeds and neighbours: every
    seed's rotation and translation within its tolerance from
    ``seed_trans_reference`` (atol 1e-4 scaled by its Horn conditioning);
    the fitness the [S, N] count of the forward's own transforms but for
    points within 1e-5 of tau^2, and -1 for a masked seed."""
    path = os.path.join(os.path.dirname(SNAP), f"PointDSC_{snapshot}_release")
    model = load_pretrained(path, device=dev)
    data = dict(scene_scale=50.0, noise=0.05) if snapshot == "SyntheticKITTI" else {}
    ds = SyntheticPairDataset(num_pairs=2, num_corr=n, inlier_ratio=0.2, seed=5,
                              inlier_threshold=model.inlier_threshold, **data)
    cp, src, tgt, labels = (torch.stack([torch.as_tensor(ds[i][k]) for i in range(2)]).to(dev)
                            for k in ("corr_pos", "src_keypts", "tgt_keypts", "gt_labels"))
    mask = torch.ones((2, n), dtype=torch.bool, device=dev)
    mask[0, n - n // 20:] = False
    mask[1, 36:] = False
    with torch.no_grad():
        kernels.reset_launches()
        out = model(cp, src, tgt, mask=mask, fused=True)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["seed_hypotheses"] == 1
        feats, seeds = out.normed_features, out.seeds
        knn = kknn.seed_knn_exact(feats, seeds, model.k, mask=mask)
        ref, tol_rot, tol_trans = kscore.seed_trans_reference(
            feats, knn, src, tgt, mask, model.sigma, model.sigma_d, model.num_iterations)
    seed_valid = torch.gather(mask, 1, seeds)
    valid_nb = torch.gather(mask[:, None, :].expand(-1, seeds.shape[1], -1), 2, knn).sum(-1)
    assert (~torch.gather(labels.bool(), 1, seeds)).sum() > 50 and (~seed_valid).any()
    assert int(valid_nb.min()) < model.k
    err = (out.seed_trans.double() - ref).abs()
    assert bool(torch.all(err[..., :3, :3].amax((-1, -2)) <= tol_rot))
    assert bool(torch.all(err[..., :3, 3].amax(-1) <= tol_trans))
    st, t2 = out.seed_trans, kscore.thr_sq(model.inlier_threshold)
    pred = torch.einsum("bsij,bnj->bsni", st[:, :, :3, :3], src) + st[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    own = torch.sum((res2 < t2) & mask[:, None, :], dim=-1)
    near = torch.sum(((res2 - t2).abs() < 1e-5 * max(1.0, t2)) & mask[:, None, :], dim=-1)
    denom = mask.sum(-1, keepdim=True).float()
    fit = out.seed_fitness
    assert bool(torch.all(torch.where(seed_valid, (fit * denom - own).abs() <= near + 1e-2,
                                      fit == -1.0)))


def test_fused_eval_forward_refuses_k_above_128(dev):
    """A fused eval forward with k = 129 (more neighbours than the hypotheses
    kernel's 128 threads) runs, the hypotheses kernel giving a thread two
    rows, and matches the dense path: final_trans atol 1e-3, labels > 0.99
    (the seed k-NN is plain above k = 128, JAX's gate)."""
    model = PointDSC(num_layers=1, k=129, device=dev, generator=torch.Generator().manual_seed(0))
    ex = SyntheticPairDataset(num_pairs=1, num_corr=1024, seed=4)[0]
    args = [torch.as_tensor(ex[k])[None].to(dev) for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    with torch.no_grad():
        kernels.reset_launches()
        out = model(*args, fused=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ref = model(*args, fused=False)
    assert counts["seed_hypotheses"] == 1 and counts["seed_knn_exact"] == 0
    torch.testing.assert_close(out.final_trans, ref.final_trans, atol=1e-3, rtol=0)
    assert float((out.final_labels == ref.final_labels).float().mean()) > 0.99


def refine_case(n, dev, far=False, seed=0):
    """B pairs, each with its own mask (sample 0 drops a random 5%, sample 1
    its last 10%), padded points set to junk 1 km out (the kernel must read
    the mask), and an initial transform near the ground truth. ``far``:
    clouds ~100 m from the origin (KITTI's case: 30 m extent, 0.2 m noise,
    half the targets moved off, threshold 1.2), else the Synthetic pairs of
    ``pair`` (threshold 0.1). Returns (init, src, tgt, mask, thr)."""
    if far:
        rng = np.random.default_rng(seed)
        src, tgt, gt = [], [], []
        for _ in range(B):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            rot = q * np.sign(np.linalg.det(q))
            t = rng.normal(size=3) * 2.0
            s_ = rng.uniform(-30.0, 30.0, size=(n, 3)) + 100.0
            t_ = s_ @ rot.T + t + rng.normal(size=(n, 3)) * 0.2
            t_[: n // 2] += rng.normal(size=(n // 2, 3)) * 10.0
            g = np.eye(4)
            g[:3, :3], g[:3, 3] = rot, t
            src.append(s_)
            tgt.append(t_)
            gt.append(g)
        src, tgt, gt = (torch.as_tensor(np.stack(a), dtype=torch.float32).to(dev)
                        for a in (src, tgt, gt))
        thr = 1.2
    else:
        src, tgt, _, gt = pair(n, dev, seed=seed)
        thr = 0.1
    gen = torch.Generator().manual_seed(seed)
    mask = torch.ones((B, n), dtype=torch.bool)
    mask[0, torch.randperm(n, generator=gen)[: n // 20]] = False
    mask[1, n - n // 10:] = False
    mask = mask.to(dev)
    src, tgt = src.clone(), tgt.clone()
    src[~mask], tgt[~mask] = 1000.0, -1000.0
    init = gt.clone()
    init[:, :3, 3] += thr * 0.3
    return init, src.contiguous(), tgt.contiguous(), mask, thr


@pytest.mark.parametrize("n", [1000, 2048, 5120, 12288, 20480])
def test_post_refinement(dev, n):
    """atol 1e-4 on the refined transform: the kernel sums the Gram terms and
    the means in another order than the plain einsums, and solves in the same
    f32 closed form. Its rounds equal the plain loop's, sample by sample."""
    init, src, tgt, mask, thr = refine_case(n, dev)
    out, iters = kref.fused_post_refinement(init, src, tgt, mask, thr, 20, return_iters=True)
    ref, rounds = kref.fused_post_refinement_plain(init, src, tgt, mask, thr, 20,
                                                   return_iters=True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert torch.equal(iters, rounds)
    assert bool(((iters >= 1) & (iters <= 20)).all())


@pytest.mark.parametrize("n", [5120, 12288])
def test_post_refinement_far_from_origin(dev, n):
    """Clouds ~100 m out with padded junk, threshold 1.2: translations of
    ~100 m, where f32's ulp is ~7.6e-6, so atol 1e-4 still holds means
    reduced in another order; the rounds equal the plain loop's."""
    init, src, tgt, mask, thr = refine_case(n, dev, far=True)
    out, iters = kref.fused_post_refinement(init, src, tgt, mask, thr, 20, return_iters=True)
    ref, rounds = kref.fused_post_refinement_plain(init, src, tgt, mask, thr, 20,
                                                   return_iters=True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert torch.equal(iters, rounds)
    assert float((out[:, :3, 3] - init[:, :3, 3]).abs().max()) < 1.0


def test_wrappers_launch_and_check(dev):
    """On CUDA tensors each wrapper launches its kernel (and counts it), and
    the attention refuses a width its kernel was not compiled for."""
    src, tgt, mask, gt = pair(512, dev)
    kernels.reset_launches()
    cache = katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    q = torch.randn((B, 512, 128), device=dev)
    katt.fused_sc_attention_cached(q, q, q, cache, src, tgt, mask=mask, offset_softmax=False)
    katt.fused_sc_attention_cached(q, q, q, cache, src, tgt, mask=mask, offset_softmax=True)
    x, _, kbias, weights = layer_case(512, dev, True)
    kenc.fused_encoder_layer(x, cache, kbias, weights)
    h, qb, kb, vb, kscale = kenc.pcn_qkv(x, weights)
    kenc.attn_mlp_residual(kscale, qb, kb, vb, cache, kbias, h, weights)
    w = [torch.zeros(shape, device=dev) for shape in ((32, 128), (32,), (32, 32), (32,),
                                                       (1, 32), (1,))]
    kconf.confidence_head(q, kconf.pack_head_weights(*w))
    keys = knms.nms_local_max(src, q[..., 0].contiguous(), 0.1, mask=mask, keys=True)
    knms.nms_select(keys, 51)
    knms.nms_top_m(q[..., 0].contiguous(), mask, 256, 51)
    seeds = torch.arange(51, device=dev).expand(B, 51).contiguous()
    kknn.seed_knn_exact(torch.nn.functional.normalize(q, dim=-1), seeds, 8, mask=mask)
    kscore.seed_inlier_counts(gt[:, None].contiguous(), src, tgt, 0.1, mask=mask)
    f = torch.nn.functional.normalize(q, dim=-1)
    kknn_idx = kknn.seed_knn_plain(f, seeds, 8, kknn.knn_bias(mask, f))
    kscore.seed_hypotheses(f, seeds, kknn_idx, src, tgt, mask, torch.ones(1, device=dev), 0.1,
                           0.1, 10)
    kref.fused_post_refinement(gt, src, tgt, mask, 0.1, 20)
    katt.fused_sc_attention(q, q, q, src, tgt, 0.1, mask=mask)
    geom = katt.pack_geometry(src, tgt, mask)
    out, lse = katt.sc_attention_forward(q, q, q, geom, 0.1)
    dvec = torch.sum(out * q, dim=-1)
    katt.sc_attention_backward_dq(q, q, q, geom, lse, dvec, q, 0.1)
    katt.sc_attention_backward_dkv(q, q, q, geom, lse, dvec, q, 0.1)
    strips = ksm.pack_labels(torch.ones((B, 512), device=dev), mask)
    scalars = torch.tensor([[1.0, 0.5, 0.5, 0.0]] * B, device=dev)
    ksm.sm_loss_sums(q, strips, scalars)
    ksm.sm_loss_grads(q, strips, scalars)
    knn_s.nearest_neighbors(src, tgt, mask)
    ksym.build_compat_cache_int8_sym(src, tgt, 0.1, mask=mask)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts.pop("compat_cache_int8") == 2  # this test's and layer_case's
    assert counts.pop("seed_inlier_counts") == 2  # its own and seed_hypotheses'
    assert counts == {name: 1 for name in counts}
    # a width above 128 runs (two chunks of 128), held to the plain versions
    wide = torch.randn((B, 512, 192), generator=torch.Generator().manual_seed(2)).to(dev)
    wh = wide.bfloat16()
    torch.testing.assert_close(
        katt.fused_sc_attention_cached(wide, wide, wide, cache, src, tgt, mask=mask,
                                       offset_softmax=False),
        katt.sc_attention_cached_plain(wh, wh, wh, cache, geom[:, 8].contiguous()),
        atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(katt.sc_attention_trainable(wide, wide, wide, geom, 0.1),
                               katt.sc_attention_forward_plain(wide, wide, wide, geom, 0.1)[0],
                               atol=1e-4, rtol=1e-4)
    fw = torch.nn.functional.normalize(wide, dim=-1)
    for a, b in zip(ksm.sm_loss_sums(fw, strips, scalars),
                    ksm.sm_loss_sums_plain(fw, strips, scalars)):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-5)
    with pytest.raises(ValueError):
        katt.sc_attention_forward(q.double(), q.double(), q.double(), geom.double(), 0.1)


def test_forward_on_card_matches_cpu(dev):
    """The fused forward on the card (kernels) against the same model's
    fused forward on the CPU (plain versions), the Synthetic snapshot at full
    width: final_trans atol 1e-3, label agreement > 0.99."""
    model = load_pretrained(SNAP, device="cpu")
    ex = SyntheticPairDataset(num_pairs=1, num_corr=1024, seed=4)[0]
    args = [torch.as_tensor(ex[k])[None] for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    ref = model(*args, fused=True)
    out = model.to(dev)(*(a.to(dev) for a in args), fused=True)
    torch.testing.assert_close(out.final_trans.cpu(), ref.final_trans, atol=1e-3, rtol=0)
    assert float((out.final_labels.cpu() == ref.final_labels).float().mean()) > 0.99


def test_fused_forward_under_the_seed_knn_gate(dev):
    """At N = 1024 (under the 4096 gate) and k = 16 the fused forward runs the
    confidence kernel and the plain seed k-NN, as the JAX model does, and
    agrees with the dense path: final_trans atol 1e-3, labels > 0.99. The
    running-max configuration, exact for any weights."""
    model = load_pretrained(SNAP, device=dev, offset_softmax=False)
    model.k = 16
    ex = SyntheticPairDataset(num_pairs=1, num_corr=1024, seed=4)[0]
    args = [torch.as_tensor(ex[k])[None].to(dev) for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    with torch.no_grad():
        kernels.reset_launches()
        out = model(*args, fused=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ref = model(*args, fused=False)
    assert counts["seed_knn_exact"] == 0 and counts["confidence_head"] == 1
    assert counts["sc_attention_cached"] == 12
    torch.testing.assert_close(out.final_trans, ref.final_trans, atol=1e-3, rtol=0)
    assert float((out.final_labels == ref.final_labels).float().mean()) > 0.99


@pytest.mark.parametrize("offset_softmax", [True, False])
def test_fused_forward_at_c32_matches_dense(dev, offset_softmax):
    """A two-layer C = 32, k = 16 model (random weights of seed 0, as
    tests/test_fused_model.py) at N = 4096 fused on the card: the kernels
    take the width zero-padded to 128 (the whole-layer kernels by default,
    the running-max attention with ``offset_softmax=False``, the seed k-NN
    and the seed stage), and the result matches the dense path at atol 1e-3
    with labels > 0.99."""
    model = PointDSC(num_layers=2, num_channels=32, k=16, offset_softmax=offset_softmax,
                     device=dev, generator=torch.Generator().manual_seed(0))
    ex = SyntheticPairDataset(num_pairs=1, num_corr=4096, seed=4)[0]
    args = [torch.as_tensor(ex[k])[None].to(dev) for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    with torch.no_grad():
        kernels.reset_launches()
        out = model(*args, fused=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ref = model(*args, fused=False)
    attention = "fused_encoder_layer" if offset_softmax else "sc_attention_cached"
    assert counts[attention] == 2 and counts["confidence_head"] == 0
    assert counts["seed_knn_exact"] == 1 and counts["seed_hypotheses"] == 1
    torch.testing.assert_close(out.final_trans, ref.final_trans, atol=1e-3, rtol=0)
    assert float((out.final_labels == ref.final_labels).float().mean()) > 0.99


def test_fused_forward_beyond_8192_seeds(dev):
    """Ratio 1.0 at N = 8256: 8256 seeds, more than the select sorts in
    shared memory. The fused forward's seeds equal the same selection on the
    CPU (the plain flags and a stable sort) exactly, and the dense NMS's
    (exact distances) on the same confidences but where a pair sits at the
    radius within a rounding; final_trans matches the dense path at atol
    1e-3. The running-max configuration, exact for any weights."""
    from pointdsc_tpu_torch.ops.knn import pairwise_dists_exact
    from pointdsc_tpu_torch.ops.nms import pick_seeds_nms

    n = 8256
    model = PointDSC(num_layers=2, ratio=1.0, offset_softmax=False, device=dev,
                     generator=torch.Generator().manual_seed(0))
    ex = SyntheticPairDataset(num_pairs=1, num_corr=n, seed=4)[0]
    args = [torch.as_tensor(ex[k])[None].to(dev) for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    with torch.no_grad():
        kernels.reset_launches()
        out = model(*args, fused=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ref = model(*args, fused=False)
    assert out.seeds.shape == (1, n) and counts["nms_select"] == 1
    plain = knms.pick_seeds_nms_prefiltered(args[1].cpu(), out.confidence.cpu(),
                                            model.nms_radius, n)
    assert torch.equal(out.seeds.cpu(), plain)
    dense = pick_seeds_nms(pairwise_dists_exact(args[1]), out.confidence, model.nms_radius, n)
    assert float((dense == out.seeds).float().mean()) > 0.99
    torch.testing.assert_close(out.final_trans, ref.final_trans, atol=1e-3, rtol=0)


# ------------------------------------------------------------ training kernels

def train_attention_inputs(dev, n, seed=1):
    """q, k, v, dO [B, n, 128] and the packed geometry of B pairs (the second
    padded). Unit-variance q and k: logits of standard deviation ~1."""
    src, tgt, mask, _ = pair(n, dev)
    gen = torch.Generator().manual_seed(seed)
    q, k, v, d_out = (torch.randn((B, n, 128), generator=gen).to(dev) for _ in range(4))
    return q, k, v, d_out, katt.pack_geometry(src, tgt, mask), (src, tgt, mask)


@pytest.mark.parametrize("n", [1000, 2048])
def test_compat_from_geometry_is_the_kernels(dev, n):
    """Constant q and k rows make every logit compat times one constant, so
    the result shows compat alone: kernel and plain version then agree to the
    order of the n-term sums (1e-5), which they could not if their compat
    entries differed in the last bits (a difference is divided by 0.01)."""
    q, k, v, _, geom, _ = train_attention_inputs(dev, n)
    ones = torch.full_like(q, 0.25)
    out, lse = katt.sc_attention_forward(ones, ones, v, geom, 0.1)
    ref, ref_lse = katt.sc_attention_forward_plain(ones, ones, v, geom, 0.1)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1000, 2048])
def test_sc_attention_train_forward(dev, n):
    """out and lse, atol = rtol = 1e-4: compat is the same bit for bit (the
    kernel evaluates the plain version's rounded operations), the 128-term
    logits and the n-term sums run in another order."""
    q, k, v, _, geom, _ = train_attention_inputs(dev, n)
    out, lse = katt.sc_attention_forward(q, k, v, geom, 0.1)
    ref, ref_lse = katt.sc_attention_forward_plain(q, k, v, geom, 0.1)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [1000, 2048, 5120])
def test_sc_attention_nocache(dev, n):
    """The eval attention without a cache (the running-max tensor-core loop
    with the geometry compat source) against its plain version on the bf16
    operands the wrapper rounds f32 inputs to, the second pair's last 10%
    masked: atol = rtol = 2e-3, the CPU test's tolerance against JAX's kernel
    (a p on a bf16 rounding boundary may round either way: the kernel rounds
    p against each tile's running max, the plain version against the row's
    maximum). Its compat is the plain version's bit for bit. f32 inputs give
    the bf16 inputs' result bit for bit; one launch per call."""
    q, k, v, _, geom, (src, tgt, mask) = train_attention_inputs(dev, n)
    kernels.reset_launches()
    out = katt.fused_sc_attention(q, k, v, src, tgt, 0.1, mask=mask)
    assert katt.fused_sc_attention.launches == 1
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref = katt.sc_attention_nocache_plain(qh, kh, vh, geom, 0.1)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)
    assert torch.equal(katt.fused_sc_attention(qh, kh, vh, src, tgt, 0.1, mask=mask), out)


@pytest.mark.parametrize("n", [1000, 2048])
def test_sc_attention_train_backward(dev, n):
    """dq, dk, dv from the plain version's lse, atol = rtol = 2e-4 (sums of n
    terms of either sign, in another order)."""
    q, k, v, d_out, geom, _ = train_attention_inputs(dev, n)
    out, lse = katt.sc_attention_forward_plain(q, k, v, geom, 0.1)
    dvec = torch.sum(d_out * out, dim=-1)
    args = (q, k, v, geom, lse, dvec, d_out, 0.1)
    ref = katt.sc_attention_backward_plain(*args)
    got = (katt.sc_attention_backward_dq(*args), *katt.sc_attention_backward_dkv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4, msg=lambda m: f"{name}: {m}")
    # a padded key's P is exactly 0: no gradient reaches it
    pad = n - n // 10
    assert float(got[1][1, pad:].abs().max()) == 0.0 and float(got[2][1, pad:].abs().max()) == 0.0


def test_sc_attention_trainable_function(dev):
    """The Function on the card against itself on the CPU (plain versions)."""
    n = 1000
    q, k, v, d_out, geom, _ = train_attention_inputs(dev, n)
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = [t.detach().to(where).clone().requires_grad_() for t in (q, k, v)]
        out = katt.sc_attention_trainable(*leaves, geom.to(where), 0.1)
        out.backward(d_out.to(where))
        grads[where] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


def attention_operands(dev, bs, n, pad, src=None, tgt=None, seed=2):
    """q, k, v, dO [bs, n, 128] of unit variance and the packed geometry of bs
    samples of n points whose last ``pad`` keys are masked in every sample;
    random points in a unit cube (tgt within ~5 cm) unless src and tgt are
    given."""
    gen = torch.Generator().manual_seed(seed)
    if src is None:
        src = torch.rand((bs, n, 3), generator=gen)
        tgt = src + 0.05 * torch.randn((bs, n, 3), generator=gen)
    mask = (torch.arange(n) < n - pad).expand(bs, n)
    q, k, v, d_out = (torch.randn((bs, n, 128), generator=gen).to(dev) for _ in range(4))
    return q, k, v, d_out, katt.pack_geometry(src.to(dev), tgt.to(dev), mask.to(dev))


def backward_case(dev, bs, n, pad, sigma_d, src=None, tgt=None, seed=2):
    """(args of the two backward wrappers, the plain version's dq, dk, dv):
    ``attention_operands``' inputs, lse and D from the plain forward."""
    q, k, v, d_out, geom = attention_operands(dev, bs, n, pad, src, tgt, seed)
    out, lse = katt.sc_attention_forward_plain(q, k, v, geom, sigma_d)
    args = (q, k, v, geom, lse, torch.sum(d_out * out, dim=-1), d_out, sigma_d)
    return args, katt.sc_attention_backward_plain(*args)


def check_backward(args, ref, pad, tol):
    """The two backward kernels against the plain version at atol = rtol =
    tol; a masked key's dK and dV rows exactly 0; a second call equal to the
    first bit for bit (one owner per output row, no atomics)."""
    got = (katt.sc_attention_backward_dq(*args), *katt.sc_attention_backward_dkv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol, msg=lambda m: f"{name}: {m}")
    if pad:
        assert float(got[1][:, -pad:].abs().max()) == 0.0
        assert float(got[2][:, -pad:].abs().max()) == 0.0
    again = (katt.sc_attention_backward_dq(*args), *katt.sc_attention_backward_dkv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, b), f"{name} differs between two calls"


@pytest.mark.parametrize("n,pad", [(1, 0), (33, 3), (64, 6), (65, 6), (1000, 100), (1024, 24)])
def test_sc_attention_train_backward_sizes(dev, n, pad):
    """dQ, dK, dV around the C = 128 kernels' 64-row owners and 32-row tiles:
    one point, a partial owner and tile, one whole owner, one row past it, a
    ragged last tile (1000) and the training shape (1000 correspondences
    padded to 1024), at atol = rtol = 2e-4 as test_sc_attention_train_backward
    holds them (sums of n terms of either sign, in another order)."""
    args, ref = backward_case(dev, B, n, pad, 0.1)
    check_backward(args, ref, pad, 2e-4)


def test_sc_attention_train_backward_kitti(dev):
    """bs 2 x N = 12288 in the KITTI regime (sigma_d 1.2, 50 m pairs of the
    SyntheticKITTI data) at atol = rtol = 5e-4, chip_smoke.py phase 12's
    tolerance at this N (sums of 12288 terms)."""
    exs = [SyntheticPairDataset(num_pairs=2, num_corr=12288, inlier_ratio=0.35, seed=3,
                                scene_scale=50.0, noise=0.05, inlier_threshold=0.6)[i]
           for i in range(2)]
    src, tgt = (torch.as_tensor(np.stack([e[key] for e in exs]))
                for key in ("src_keypts", "tgt_keypts"))
    args, ref = backward_case(dev, 2, 12288, 0, 1.2, src=src, tgt=tgt)
    check_backward(args, ref, 0, 5e-4)


@pytest.mark.parametrize("bs", [1, 16])
@pytest.mark.parametrize("n,pad", [(65, 5), (1000, 100), (1024, 24), (2049, 49)])
def test_sc_attention_train_forward_sizes(dev, bs, n, pad):
    """The C = 128 forward (64-row owners, 32-row tiles) at ragged n: a
    partial owner and tile (65), a ragged last tile (1000), the training
    shape (1000 correspondences padded to 1024) and one row past whole
    owners (2049), against the plain version at atol = rtol = 1e-4 (out and
    lse; the 128-term logits and the n-term sums in another order); a second
    call equal bit for bit (one owner per row, no atomics); each sample of
    the batch equal bit for bit to its call alone."""
    q, k, v, _, geom = attention_operands(dev, bs, n, pad, seed=n + bs)
    out, lse = katt.sc_attention_forward(q, k, v, geom, 0.1)
    ref, ref_lse = katt.sc_attention_forward_plain(q, k, v, geom, 0.1)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    again, again_lse = katt.sc_attention_forward(q, k, v, geom, 0.1)
    assert torch.equal(again, out) and torch.equal(again_lse, lse)
    for i in {0, bs - 1}:
        one, one_lse = katt.sc_attention_forward(
            *(t[i:i + 1].contiguous() for t in (q, k, v, geom)), 0.1)
        assert torch.equal(one[0], out[i]) and torch.equal(one_lse[0], lse[i])


def test_sc_attention_train_forward_all_keys_padded(dev):
    """A sample whose every key is padded (bias -1e9 on all of them, so every
    logit lies near -1e9 and the row's maximum at the -1e9 clamp) beside a
    sample with none padded: out and lse within 1e-4 of the plain version."""
    q, k, v, _, geom = attention_operands(dev, 2, 100, 0, seed=7)
    geom[1, 8] = -1e9
    out, lse = katt.sc_attention_forward(q, k, v, geom, 0.1)
    ref, ref_lse = katt.sc_attention_forward_plain(q, k, v, geom, 0.1)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())


def test_sc_attention_train_backward_from_the_forward_kernel(dev):
    """dQ, dK, dV at the training shape (bs 16, 1000 of 1024 valid) from the
    forward kernel's lse and out (D = rowsum(dO * out)) against the plain
    backward from the plain forward's, at the backward's tolerance of
    atol = rtol = 2e-4."""
    q, k, v, d_out, geom = attention_operands(dev, 16, 1024, 24, seed=11)
    out, lse = katt.sc_attention_forward(q, k, v, geom, 0.1)
    args = (q, k, v, geom, lse, torch.sum(d_out * out, dim=-1), d_out, 0.1)
    ref_out, ref_lse = katt.sc_attention_forward_plain(q, k, v, geom, 0.1)
    ref = katt.sc_attention_backward_plain(q, k, v, geom, ref_lse,
                                           torch.sum(d_out * ref_out, dim=-1), d_out, 0.1)
    got = (katt.sc_attention_backward_dq(*args), *katt.sc_attention_backward_dkv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4, msg=lambda m: f"{name}: {m}")


def sm_inputs(dev, n, seed=3, batch=B):
    gen = torch.Generator().manual_seed(seed)
    f = torch.nn.functional.normalize(torch.randn((batch, n, 128), generator=gen), dim=-1)
    gt = (torch.rand((batch, n), generator=gen) < 0.3).float()
    mask = torch.ones((batch, n), dtype=torch.bool)
    mask[batch - 1, n - n // 10:] = False
    return f.to(dev), gt.to(dev), mask.to(dev)


def sm_scalars(strips, balanced, sigma=1.07):
    wp, wn = ksm.balance_weights(strips, balanced)
    sig = torch.full_like(wp, sigma)
    return torch.stack([sig, wp, wn, torch.zeros_like(wp)], dim=-1).contiguous()


def assert_sm_close(got, ref, slack=0.0):
    """Sums rtol 1e-5 (non-negative terms; the kernel adds per-block partial
    sums), dF atol 1e-6 relative to its largest entry, dsigma rtol 1e-4
    (terms of either sign). A pair whose u lies within rounding of 0 or 1 may
    fall on either side of the gate in the two versions, and dF then moves by
    that pair's term: ``slack`` (``ksm.grads_gate_slack``) adds it where
    such a pair is."""
    (sp, sn), (df, ds) = got
    (rsp, rsn), (rdf, rds) = ref
    for a, b in ((sp, rsp), (sn, rsn)):
        torch.testing.assert_close(a.to(b.dtype), b, atol=0, rtol=1e-5)
    err = (df.to(rdf.dtype) - rdf).abs() - slack
    assert float(err.max()) <= 1e-6 * float(rdf.abs().max()) + 1e-12
    torch.testing.assert_close(ds.to(rds.dtype), rds, atol=0, rtol=1e-4)


def sm_both(f, strips, scalars):
    return ksm.sm_loss_sums(f, strips, scalars), ksm.sm_loss_grads(f, strips, scalars)


def sm_plain(f, strips, scalars):
    """The plain versions on the inputs widened to f64, and dF's slack at the
    gate. The f32 plain dF sums N terms in cuBLAS's order, whose rounding
    reaches ~1.5e-6 of its largest entry at N = 1000: more than the kernels'
    own (~5e-7), and more than the tolerance."""
    f, strips, scalars = f.double(), strips.double(), scalars.double()
    return ((ksm.sm_loss_sums_plain(f, strips, scalars), ksm.sm_loss_grads_plain(f, strips, scalars)),
            ksm.grads_gate_slack(f, strips, scalars))


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("n", [1, 31, 33, 65, 1000, 1024, 2048])
def test_sm_loss_kernels(dev, n, balanced):
    """Both kernels against their plain versions (``assert_sm_close``) at N
    below one tile, off the 32- and 64-row tiles and at the training shape,
    the second sample's last tenth masked."""
    f, gt, mask = sm_inputs(dev, n)
    strips = ksm.pack_labels(gt, mask)
    scalars = sm_scalars(strips, balanced)
    assert_sm_close(sm_both(f, strips, scalars), *sm_plain(f, strips, scalars))


def test_sm_loss_kernels_kitti_scale(dev):
    """One sample of N = 12288, its last tenth masked: the gradients' walk is
    split in two there (on a card of 132 SMs); held to the plain versions and
    the same bit for bit from run to run."""
    f, gt, mask = sm_inputs(dev, 12288, batch=1)
    strips = ksm.pack_labels(gt, mask)
    scalars = sm_scalars(strips, False)
    got = sm_both(f, strips, scalars)
    assert_sm_close(got, *sm_plain(f, strips, scalars))
    again = sm_both(f, strips, scalars)
    for a, b in zip((*got[0], *got[1]), (*again[0], *again[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [65, 1000])
def test_sm_loss_clamp_live_on_both_sides(dev, n):
    """sigma = 0.4, features in clusters and not of unit norm, so that u
    falls below 0, inside (0, 1) and above 1 (the gate and both clamps)."""
    gen = torch.Generator().manual_seed(11)
    centres = torch.nn.functional.normalize(torch.randn((B, 8, 128), generator=gen), dim=-1)
    pick = torch.randint(0, 8, (B, n), generator=gen)
    f = torch.gather(centres, 1, pick[..., None].expand(B, n, 128))
    f = torch.nn.functional.normalize(f + 0.03 * torch.randn((B, n, 128), generator=gen), dim=-1)
    f = f * (0.9 + 0.2 * torch.rand((B, n, 1), generator=gen))
    gt = (torch.rand((B, n), generator=gen) < 0.3).float()
    mask = torch.ones((B, n), dtype=torch.bool)
    mask[1, n - n // 10:] = False
    f, strips = f.to(dev), ksm.pack_labels(gt.to(dev), mask.to(dev))
    scalars = sm_scalars(strips, True, sigma=0.4)
    u = 1.0 - (1.0 - torch.einsum("bnc,bmc->bnm", f, f)) / 0.16
    assert bool((u < 0).any()) and bool(((u > 0) & (u < 1)).any()) and bool((u > 1).any())
    assert_sm_close(sm_both(f, strips, scalars), *sm_plain(f, strips, scalars))


def test_sm_loss_sample_all_masked(dev):
    """A sample whose every point is masked adds nothing: its sums, dF and
    dsigma are 0, and the other sample's are the plain version's."""
    f, gt, mask = sm_inputs(dev, 1000)
    mask[1] = False
    strips = ksm.pack_labels(gt, mask)
    scalars = sm_scalars(strips, True)
    got = sm_both(f, strips, scalars)
    assert_sm_close(got, *sm_plain(f, strips, scalars))
    (sp, sn), (df, ds) = got
    assert float(sp[1]) == 0.0 and float(sn[1]) == 0.0 and float(ds[1]) == 0.0
    assert float(df[1].abs().max()) == 0.0


@pytest.mark.parametrize("n", [1000, 12288])
def test_sm_loss_batch_rows_are_single_samples(dev, n):
    """Each row of a batch of two equals that sample alone, within the
    plain-version tolerances (the plans differ with the batch: at 12288 the
    gradients' walk is split for one sample and not for two)."""
    f, gt, mask = sm_inputs(dev, n)
    strips = ksm.pack_labels(gt, mask)
    scalars = sm_scalars(strips, False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if n == 12288 and sms == 132:
        assert ksm.grads_plan(1, n, sms)[0] == 2 and ksm.grads_plan(2, n, sms)[0] == 1
    (sp, sn), (df, ds) = sm_both(f, strips, scalars)
    for i in range(B):
        one = sm_both(f[i:i + 1], strips[i:i + 1], scalars[i:i + 1])
        assert_sm_close(one, ((sp[i:i + 1], sn[i:i + 1]), (df[i:i + 1], ds[i:i + 1])))


@pytest.mark.parametrize("case", ["ok", "no_plan", "short_split", "empty_split", "three",
                                  "no_workspace"])
def test_sm_loss_entries_check_the_plan(dev, case):
    """The C entries launch only a plan that covers their tiles: the sums
    entry takes a plan at C = 128, the gradients entry 1 or 2 consecutive
    runs of tiles, none empty, that reach the last tile, and a workspace for
    the second run; anything else is refused before a launch."""
    from pointdsc_tpu_torch.kernels import _build

    b, n = 2, 1000
    f, gt, mask = sm_inputs(dev, n)
    strips = ksm.pack_labels(gt, mask)
    scalars = sm_scalars(strips, True)
    tiles = -(-n // ksm.TILE)
    df, df_split = torch.empty_like(f), torch.empty_like(f)
    plan = ksm.grads_plan(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((plan[0], b, -(-n // ksm.OWN)), device=dev)
    splits, run, ws = {"short_split": (2, tiles // 2 - 1, df_split),
                       "empty_split": (2, tiles, df_split), "three": (3, -(-tiles // 3), df_split),
                       "no_workspace": (2, -(-tiles // 2), None)}.get(case, (*plan, df_split))

    def grads():
        _build.launch("sm_loss", "sm_loss_bwd", dev, f.data_ptr(), strips.data_ptr(),
                      scalars.data_ptr(), df.data_ptr(), None if ws is None else ws.data_ptr(),
                      partial.data_ptr(), b, n, 128, splits, run)

    if case == "no_plan":
        sums = torch.empty((1, b, 2), device=dev)
        with pytest.raises(RuntimeError, match="cudaError 1"):
            _build.launch("sm_loss", "sm_loss_fwd", dev, f.data_ptr(), strips.data_ptr(),
                          scalars.data_ptr(), None, 0, sums.data_ptr(), b, n, 128)
    elif case == "ok":
        grads()
        if splits > 1:
            df.add_(df_split)
        ref_df, ref_ds = ksm.sm_loss_grads(f, strips, scalars)
        assert torch.equal(df, ref_df) and torch.equal(torch.sum(partial, dim=(0, 2)), ref_ds)
    else:
        with pytest.raises(RuntimeError, match="cudaError 1"):
            grads()


def test_sm_loss_function_and_determinism(dev):
    """The Function on the card against itself on the CPU, and twice on the
    card: the loss and both gradients are the same bit for bit from run to
    run (fixed-order sums, no atomics)."""
    f, gt, mask = sm_inputs(dev, 1000)
    runs = []
    for where in ("cuda", "cuda", "cpu"):
        ff = f.detach().to(where).clone().requires_grad_()
        sigma = torch.tensor([0.9], device=where, requires_grad=True)
        loss = ksm.fused_spectral_matching_loss(ff, sigma, gt.to(where), mask.to(where), True)
        loss.backward()
        runs.append((loss.detach().cpu(), ff.grad.cpu(), sigma.grad.cpu()))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    torch.testing.assert_close(runs[0][0], runs[2][0], atol=0, rtol=1e-5)
    assert float((runs[0][1] - runs[2][1]).abs().max()) <= 1e-6 * float(runs[2][1].abs().max())
    torch.testing.assert_close(runs[0][2], runs[2][2], atol=0, rtol=1e-4)


# ------------------------------------------------------------ registration path

def plain_nn(query, base, base_mask=None):
    """nearest_neighbors through its plain version, on the card."""
    single = query.ndim == 2
    qp, bp = knn_s.pack_points(query), knn_s.pack_points(base, base_mask)
    d2, idx = knn_s.nearest_neighbors_plain(qp[None] if single else qp,
                                            bp[None] if single else bp)
    return (d2[0], idx[0]) if single else (d2, idx)


@pytest.mark.parametrize("n,m", [(1000, 1500), (2048, 777), (65, 3000)])
@pytest.mark.parametrize("mask_share", [None, 0.3, 1.0])
def test_nearest_neighbors(dev, n, m, mask_share):
    """d2 equal bit for bit (rounded operations in the plain version's
    order); the index equal, or the d2 at both indices equal. Batch 2, ragged
    sizes (the kernel's 64-row blocks and 1024-point tiles do not divide
    them); every base point masked gives (1e30, 0)."""
    gen = torch.Generator().manual_seed(n + m)
    q = (torch.rand((B, n, 3), generator=gen) * 3.0).to(dev)
    b = (torch.rand((B, m, 3), generator=gen) * 3.0).to(dev)
    mask = None if mask_share is None else (torch.rand((B, m), generator=gen) >= mask_share).to(dev)
    d2, idx = knn_s.nearest_neighbors(q, b, mask)
    rd, ri = plain_nn(q, b, mask)
    assert torch.equal(d2, rd)
    diff = idx != ri
    rows = diff.nonzero()
    for bi, r in rows.tolist():
        qp = knn_s.pack_points(q[bi, r])
        bp = knn_s.pack_points(b[bi], None if mask is None else mask[bi])
        at = lambda i: (qp[3] + bp[i, 3]) - 2.0 * ((qp[0] * bp[i, 0] + qp[1] * bp[i, 1])
                                                   + qp[2] * bp[i, 2])
        assert torch.equal(at(idx[bi, r]), at(ri[bi, r]))
    if mask_share == 1.0:
        assert bool((idx == 0).all()) and bool((d2 == 1e30).all())
    for i in range(B):  # a batch row is the single-pair call
        d2i, idxi = knn_s.nearest_neighbors(q[i].contiguous(), b[i].contiguous(),
                                            None if mask is None else mask[i].contiguous())
        assert torch.equal(d2i, d2[i]) and torch.equal(idxi, idx[i])


def assert_nn_matches_plain(q, b, mask):
    """The kernel's (d2, idx) of a batch against the plain version's: d2
    equal bit for bit, idx int64 and equal or tied (the d2 at both indices
    equal); returns them."""
    d2, idx = knn_s.nearest_neighbors(q, b, mask)
    rd, ri = plain_nn(q, b, mask)
    assert idx.dtype == torch.int64 and d2.dtype == torch.float32
    assert torch.equal(d2, rd)
    for bi, r in (idx != ri).nonzero().tolist():
        qp = knn_s.pack_points(q[bi, r])
        bp = knn_s.pack_points(b[bi], None if mask is None else mask[bi])
        at = lambda i: (qp[3] + bp[i, 3]) - 2.0 * ((qp[0] * bp[i, 0] + qp[1] * bp[i, 1])
                                                   + qp[2] * bp[i, 2])
        assert torch.equal(at(idx[bi, r]), at(ri[bi, r]))
    return d2, idx


def nn_splits(dev, batch, n, m):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return knn_s.nn_grid(batch, n, m, sms)


@pytest.mark.parametrize("n", [64, 513, 2048])
@pytest.mark.parametrize("mask_share", [None, 0.3, 1.0])
def test_nearest_neighbors_split_base(dev, n, mask_share):
    """N = 64-2048 queries against M = 20480 base points, batch 2: the base is
    cut into ranges over many blocks, merged by 64-bit keys. Against the plain
    version (d2 bit for bit, indices equal or tied; every base point masked:
    (1e30, 0)); a second call equal bit for bit, whichever blocks finish
    first."""
    m = 20480
    assert nn_splits(dev, B, n, m)[1] > 1
    gen = torch.Generator().manual_seed(n)
    b = (torch.rand((B, m, 3), generator=gen) * 3.0).to(dev)
    q = (b[:, :n] + 0.01 * torch.randn((B, n, 3), generator=gen).to(dev)).contiguous()
    mask = None if mask_share is None else (torch.rand((B, m), generator=gen) >= mask_share).to(dev)
    d2, idx = assert_nn_matches_plain(q, b, mask)
    if mask_share == 1.0:
        assert bool((idx == 0).all()) and bool((d2 == 1e30).all())
    again = knn_s.nearest_neighbors(q, b, mask)
    assert torch.equal(again[0], d2) and torch.equal(again[1], idx)


def test_nearest_neighbors_ties_across_splits(dev):
    """Copies of one point on both sides of each boundary between base ranges
    (and one more range on): a query at the point gets the lowest index, as
    in the plain version, whichever block finishes first."""
    n, m = 256, 20480
    _, splits, rng = nn_splits(dev, 1, n, m)
    assert splits - 2 >= n  # every query its own boundary
    gen = torch.Generator().manual_seed(5)
    b = torch.rand((m, 3), generator=gen) * 3.0
    q = torch.rand((n, 3), generator=gen) * 3.0
    first = []
    for i in range(n):
        s = 1 + i
        at = [s * rng - 1, s * rng, (s + 1) * rng + 3]
        b[at] = q[i]
        first.append(at[0])
    q, b = q.to(dev), b.to(dev)
    d2, idx = knn_s.nearest_neighbors(q, b)
    rd, ri = plain_nn(q, b)
    assert torch.equal(d2, rd) and torch.equal(idx, ri)
    assert idx.tolist() == first


def test_nearest_neighbors_negative_d2(dev):
    """Points ~100 m from the origin and queries within 1e-5 of base points:
    the rounding of |q|^2 + |b|^2 - 2 q.b (~4e-3 there) makes some d2
    negative, which the merge's keys must order below zero. d2 bit for bit
    the plain version's, indices equal or tied."""
    n, m = 1024, 20480
    assert nn_splits(dev, 1, n, m)[1] > 1
    gen = torch.Generator().manual_seed(9)
    b = 100.0 + torch.rand((1, m, 3), generator=gen) * 3.0
    pick = torch.randperm(m, generator=gen)[:n]
    q = b[:, pick] + 1e-5 * torch.randn((1, n, 3), generator=gen)
    d2, _ = assert_nn_matches_plain(q.to(dev), b.to(dev), None)
    assert bool((d2 < 0).any()) and bool((d2 > 0).any())


@pytest.mark.parametrize("plan", ["ok", "qblocks", "short_workspace", "no_workspace"])
def test_nearest_neighbors_entry_checks_the_plan(dev, plan):
    """The C entry launches only the plan it was built for: query blocks of
    its own 512 rows (the counters are indexed by them) and a merge
    workspace of at least 8 B N + 4 B qblocks bytes; anything else is
    refused before a launch."""
    from pointdsc_tpu_torch.kernels import _build

    b, n, m = 2, 600, 20480
    qblocks, splits, rng = nn_splits(dev, b, n, m)
    assert qblocks == 2 and splits > 1
    q, bp = torch.rand((b, n, 3), device=dev), torch.rand((b, m, 3), device=dev)
    d2 = torch.empty((b, n), device=dev)
    idx = torch.empty((b, n), dtype=torch.int64, device=dev)
    words = b * n + b * qblocks // 2
    work = torch.empty((words,), dtype=torch.int64, device=dev)
    args = dict(qblocks=qblocks, work=work.data_ptr(), words=words)
    args.update({"ok": {}, "qblocks": {"qblocks": qblocks + 1},
                 "short_workspace": {"words": words - 1}, "no_workspace": {"work": 0}}[plan])

    def call():
        _build.launch("nn_search", "nearest_neighbors", dev, q.data_ptr(), bp.data_ptr(), 0,
                      d2.data_ptr(), idx.data_ptr(), args["work"], b, n, m, args["qblocks"],
                      splits, rng, args["words"])

    if plan == "ok":
        call()
        assert torch.equal(d2, knn_s.nearest_neighbors(q, bp)[0])
    else:
        with pytest.raises(RuntimeError, match="cudaError 1"):
            call()


@pytest.mark.parametrize("n,m", [(20480, 20480), (2048, 2048), (2048, 40)])
def test_nearest_neighbors_device_operations(dev, n, m):
    """A search is one device operation where the base is one range (M = 40)
    and two where it is split over blocks: the merge's workspace set to
    ones, then the kernel (it reads the clouds and the mask in place and writes
    the int64 index); at N = M = 2048 the grid has a block for every SM."""
    gen = torch.Generator().manual_seed(1)
    q, b = (torch.rand((s, 3), generator=gen).to(dev) for s in (n, m))
    mask = torch.rand((m,), generator=gen).to(dev) > 0.1
    qblocks, splits, _ = nn_splits(dev, 1, n, m)
    assert (splits > 1) == (m > 40)
    if n == m == 2048:
        assert qblocks * splits >= torch.cuda.get_device_properties(dev).multi_processor_count
    assert device_operations(lambda: knn_s.nearest_neighbors(q, b, mask)) == (2 if splits > 1
                                                                               else 1)
    assert_nn_matches_plain(q[None], b[None], mask[None])


@pytest.mark.parametrize("batch", [1, B])
@pytest.mark.parametrize("n", [512, 1000, 1024, 2048, 5000, 12288])
def test_symmetric_cache(dev, n, batch):
    """Byte for byte the full-grid kernel's cache (at batch 2 the second
    pair's last 10% is masked, which neither build reads); exactly
    symmetric; within +-1 on <= 0.1% of entries of its plain version. N = 1000
    and 5000 take the ragged edge's 8-byte stores (N % 16 == 8)."""
    src, tgt, mask, _ = pair(n, dev)
    src, tgt, mask = src[:batch], tgt[:batch], mask[:batch]
    sym = ksym.build_compat_cache_int8_sym(src, tgt, 0.1, mask=mask)
    assert torch.equal(sym, katt._launch_compat_cache(src, tgt, katt.cache_coef(0.1)))
    assert torch.equal(sym, sym.transpose(1, 2))
    plain = ksym.compat_cache_sym_plain(katt.pack_geometry(src, tgt, mask), katt.cache_coef(0.1))
    diff = (sym.int() - plain.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 1).float().mean()) <= 1e-3


@pytest.mark.parametrize("n", [1, 31, 513, 1001, 1002, 1004])
def test_symmetric_cache_edges(dev, n):
    """Sizes below a band and a strip, and every store unit of a ragged N
    (1, 2 and 4 bytes), with repeated points (zero distances off the
    diagonal, the rows that fall back to sqrtf): the full-grid kernel's bytes."""
    gen = torch.Generator().manual_seed(n)
    src = torch.rand((B, n, 3), generator=gen)
    tgt = src + 0.01 * torch.randn((B, n, 3), generator=gen)
    src[:, n // 2], tgt[:, n // 2] = src[:, 0], tgt[:, 0]
    src, tgt = src.to(dev), tgt.to(dev)
    sym = ksym.build_compat_cache_int8_sym(src, tgt, 0.1)
    assert torch.equal(sym, katt._launch_compat_cache(src, tgt, katt.cache_coef(0.1)))


@pytest.mark.parametrize("n", [5000, 5120, 12288, 20480])
def test_production_cache(dev, n):
    """The eval forward's cache build, on the route ``use_symmetric_cache``
    takes: the full-grid kernel's bytes, in one device operation."""
    src, tgt, mask, _ = pair(n, dev)
    sigma_d = 0.1 if n <= 5120 else 1.2

    def build():
        return katt.build_compat_cache_int8(src, tgt, sigma_d, mask=mask)

    assert torch.equal(build(), katt._launch_compat_cache(src, tgt, katt.cache_coef(sigma_d)))
    assert device_operations(build) == 1


def test_icp_on_card_matches_plain_search(dev, monkeypatch):
    """ICP and the information matrix with the kernel against the same code
    through the plain search, batch 2 with masks: the same d2 bit for bit,
    hence the same transforms (atol 1e-6) and the same [5, 5] count."""
    src, tgt, mask, gt = pair(1000, dev)
    init = gt.clone()
    init[:, :3, 3] += 0.02
    kernels.reset_launches()
    out = icp_mod.icp_point_to_point(src, tgt, init, 0.1, src_mask=mask, tgt_mask=mask)
    info = icp_mod.information_matrix(src, tgt, gt, 0.1, src_mask=mask, tgt_mask=mask)
    assert kernels.launch_counts()["nearest_neighbors"] == 21
    monkeypatch.setattr(icp_mod, "nearest_neighbors", plain_nn)
    ref = icp_mod.icp_point_to_point(src, tgt, init, 0.1, src_mask=mask, tgt_mask=mask)
    ref_info = icp_mod.information_matrix(src, tgt, gt, 0.1, src_mask=mask, tgt_mask=mask)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    torch.testing.assert_close(info, ref_info, atol=1e-5 * float(ref_info.abs().max()), rtol=0)
    assert torch.equal(info[:, 5, 5], ref_info[:, 5, 5])


def test_fpfh_on_card_matches_cpu(dev):
    """FPFH's radius k-NN rounds its gram-form d2 alike on the card and the
    CPU, so both neighbourhoods (normals: 30 within 2 voxels; features: 100
    within 5) are equal bit for bit on voxel-mean keypoints, and the features
    meet the CPU parity rule (>= 99.5% of the entries within 1e-3)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import make_scene
    from pointdsc_tpu_torch.descriptors import fpfh

    src = make_scene(0, n_points=30_000, room=1.0, overlap_cut=(0.8, 0.24))[0]
    pts = torch.as_tensor(fpfh.voxel_downsample(src, 0.03))
    for k, radius in ((30, 0.06), (100, 0.15)):
        idx, valid = fpfh._chunked_radius_knn(pts.to(dev), k, radius)
        ref_idx, ref_valid = fpfh._chunked_radius_knn(pts, k, radius)
        assert torch.equal(idx.cpu(), ref_idx) and torch.equal(valid.cpu(), ref_valid)
    keypts, feats = fpfh.extract_fpfh(src, voxel_size=0.03, device=dev)
    ref_keypts, ref_feats = fpfh.extract_fpfh(src, voxel_size=0.03, device="cpu")
    np.testing.assert_array_equal(keypts, ref_keypts)
    assert (np.abs(feats - ref_feats) <= 1e-3).mean() >= 0.995


# ------------------------------------------------------------ widths above 128 (C12)
#
# A wider model's channels are zero-padded to a multiple of 128 and every
# kernel walks them in chunks of 128: the attentions make one pass per output
# chunk, the logits summed over all chunks in each. Held to the plain
# versions at the narrow kernels' tolerances; C = 160 and 384 are not
# multiples of 128 (padded to 256 and 384), C = 384 takes three chunks.

WIDE_CS = [160, 256, 384]


@pytest.mark.parametrize("c", WIDE_CS)
def test_wide_cached_attention(dev, c):
    """The running-max and the offset kernels over the int8 cache at N = 1000
    (ragged), the second pair's last 10% masked, against their plain
    versions on the bf16 operands: atol = rtol = 2e-3 (test_sc_attention);
    one launch a call."""
    src, tgt, mask, _ = pair(1000, dev)
    gen = torch.Generator().manual_seed(c)
    q, k, v = (torch.randn((B, 1000, c), generator=gen).to(dev) for _ in range(3))
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    geom = katt.pack_geometry(src, tgt, mask)
    cache = katt.compat_cache_plain(geom, katt.cache_coef(0.1))
    bias = geom[:, 8].contiguous()
    for offset, plain in ((False, katt.sc_attention_cached_plain),
                          (True, katt.sc_attention_cached_offset_plain)):
        kernels.reset_launches()
        out = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                             offset_softmax=offset)
        assert sum(kernels.launch_counts().values()) == 1 and out.shape == q.shape
        torch.testing.assert_close(out, plain(qh, kh, vh, cache, bias), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("c", WIDE_CS)
def test_wide_nocache_attention(dev, c):
    """The running max without a cache at N = 1000 against its plain version
    on the bf16 operands, atol = rtol = 2e-3 (test_sc_attention_nocache)."""
    src, tgt, mask, _ = pair(1000, dev)
    gen = torch.Generator().manual_seed(c)
    q, k, v = (torch.randn((B, 1000, c), generator=gen).to(dev) for _ in range(3))
    out = katt.fused_sc_attention(q, k, v, src, tgt, 0.1, mask=mask)
    ref = katt.sc_attention_nocache_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                          katt.pack_geometry(src, tgt, mask), 0.1)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("c", WIDE_CS)
def test_wide_encoder_layer(dev, c):
    """The split pair above C = 128 (the one-launch kernel refuses the width
    and ``fused_layer`` runs the pair at every N): PointCN + QKV at N = 1000
    (ragged), h and kscale as test_pcn_qkv holds them, q, k, v within one
    bf16 step and 1e-5 (see below), the attention + MLP + residual on the
    plain version's own h, q, k, v, kscale at N = 512, masked, and the layer
    through ``fused_layer`` against the plain layer, atol = rtol = 2e-3."""
    x, weights = pcn_case(1000, dev, c=c)
    got, ref = kenc.pcn_qkv(x, weights), kenc.pcn_qkv_plain(x, weights)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    for g, want in zip(got[1:4], ref[1:4]):
        # q, k, v: sums of C terms in another order land up to ~1e-6 apart in
        # f32 at C = 384, so a value near zero may round more than its own
        # bf16 step away; a value on a rounding boundary by one step
        diff = (g.float() - want.float()).abs()
        assert bool((diff <= want.float().abs() * 2.0 ** -7 + 1e-5).all())
        assert float((diff > 0).float().mean()) <= 1e-2
    torch.testing.assert_close(got[4], ref[4], atol=0, rtol=1e-5)
    x, cache, kbias, weights = layer_case(512, dev, True, c=c)
    h, q, k, v, kscale = kenc.pcn_qkv_plain(x, weights)
    out = kenc.attn_mlp_residual(kscale, q, k, v, cache, kbias, h, weights)
    ref = kenc.attn_mlp_residual_plain(kscale, q, k, v, cache, kbias, h, weights)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)
    kernels.reset_launches()
    ws = kenc.new_workspace(B, 512, kchk.padded_width(c), dev)
    out = kenc.fused_layer(x, cache, kbias, weights, ws)
    assert kernels.launch_counts()["pcn_qkv"] == 1
    assert kernels.launch_counts()["attn_mlp_residual"] == 1
    torch.testing.assert_close(out, kenc.fused_layer_plain(x, cache, kbias, weights),
                               atol=2e-3, rtol=2e-3)
    with pytest.raises(ValueError, match="pair"):
        kenc.fused_encoder_layer(x, cache, kbias, weights)


@pytest.mark.parametrize("c", WIDE_CS)
def test_wide_train_attention(dev, c):
    """The trainable attention's forward (out and lse, atol = rtol = 1e-4)
    and its two backward kernels (atol = rtol = 2e-4) at N = 1000, as
    test_sc_attention_train_forward and _backward hold them; no gradient
    reaches a padded key."""
    src, tgt, mask, _ = pair(1000, dev)
    gen = torch.Generator().manual_seed(c)
    q, k, v, d_out = (torch.randn((B, 1000, c), generator=gen).to(dev) for _ in range(4))
    geom = katt.pack_geometry(src, tgt, mask)
    out, lse = katt.sc_attention_forward(q, k, v, geom, 0.1)
    ref, ref_lse = katt.sc_attention_forward_plain(q, k, v, geom, 0.1)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    dvec = torch.sum(d_out * ref, dim=-1)
    args = (q, k, v, geom, ref_lse, dvec, d_out, 0.1)
    got = (katt.sc_attention_backward_dq(*args), *katt.sc_attention_backward_dkv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, katt.sc_attention_backward_plain(*args)):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4, msg=lambda m: f"{name}: {m}")
    assert float(got[1][1, 900:].abs().max()) == 0.0 and float(got[2][1, 900:].abs().max()) == 0.0


@pytest.mark.parametrize("c", WIDE_CS)
def test_wide_sm_loss(dev, c):
    """The SM-loss sums (rtol 1e-5), dF (atol 1e-6 of its largest entry) and
    dsigma (rtol 1e-4) at N = 1000, as test_sm_loss_kernels holds them."""
    gen = torch.Generator().manual_seed(c)
    f = torch.nn.functional.normalize(torch.randn((B, 1000, c), generator=gen), dim=-1).to(dev)
    gt = (torch.rand((B, 1000), generator=gen) < 0.3).float().to(dev)
    mask = torch.ones((B, 1000), dtype=torch.bool, device=dev)
    mask[1, 900:] = False
    strips = ksm.pack_labels(gt, mask)
    wp, wn = ksm.balance_weights(strips, True)
    sigma = torch.full((B,), 1.07, device=dev)
    scalars = torch.stack([sigma, wp, wn, torch.zeros_like(wp)], dim=-1).contiguous()
    for a, b in zip(ksm.sm_loss_sums(f, strips, scalars),
                    ksm.sm_loss_sums_plain(f, strips, scalars)):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-5)
    (df, ds), (rdf, rds) = ksm.sm_loss_grads(f, strips, scalars), \
        ksm.sm_loss_grads_plain(f, strips, scalars)
    assert df.shape == f.shape
    assert float((df - rdf).abs().max()) <= 1e-6 * float(rdf.abs().max()) + 1e-12
    torch.testing.assert_close(ds, rds, atol=0, rtol=1e-4)


@pytest.mark.parametrize("c", WIDE_CS)
def test_wide_seed_knn(dev, c):
    """The seed k-NN on C-wide features (the product walks the padded
    channels 32 at a time) against the plain sort, near ties aside, at
    N = 5120, S = 512, k = 40."""
    gen = torch.Generator().manual_seed(c)
    n = 5120
    f = torch.nn.functional.normalize(torch.randn((B, n, c), generator=gen), dim=-1).to(dev)
    seeds = torch.stack([torch.randperm(n, generator=gen)[: n // 10] for _ in range(B)]).to(dev)
    _, _, mask, _ = pair(n, dev)
    idx = kknn.seed_knn_exact(f, seeds, 40, mask=mask)
    ref = kknn.seed_knn_plain(f, seeds, 40, kknn.knn_bias(mask, f))
    sf = torch.gather(f, 1, seeds[..., None].expand(-1, -1, c))
    assert knn_sets_agree(idx, ref, torch.einsum("bsc,bnc->bsn", sf, f), 40)


@pytest.mark.parametrize("k,c", [(129, 128), (200, 128), (256, 128), (100, 512)])
def test_seed_hypotheses_above_128_neighbours(dev, k, c):
    """The hypotheses kernel with more neighbours than threads (a thread owns
    rows t + 128 i): M in shared memory at k = 129, in its device workspace at
    k = 200 and 256 (k x (k + 1) floats beside the features pass the 200 KB
    arena), the features in theirs at C = 512 (k x 516 floats); every seed
    transform against the f64 plain version within its tolerance
    (``seed_trans_reference``), at batch 2, the second sample padded."""
    from pointdsc_tpu_torch.data.synthetic import seed_stage_inputs

    assert kscore.hypotheses_layout(k, c) == {129: (False, False), 200: (False, True),
                                             256: (False, True), 100: (True, False)}[k]
    d = seed_stage_inputs(4096, batch=B, channels=c, pad_fraction=0.1)
    f, seeds, src, tgt, mask = (torch.as_tensor(d[key]).to(dev)
                                for key in ("feats", "seeds", "src", "tgt", "mask"))
    knn = kknn.seed_knn_plain(f, seeds, k, kknn.knn_bias(mask, f))
    sigma = torch.full((1,), 0.8, device=dev)
    args = (f, seeds, knn, src, tgt, mask, sigma, d["sigma_d"], d["inlier_threshold"], 10)
    kernels.reset_launches()
    trans = kscore.seed_hypotheses(*args)[0]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["seed_hypotheses"] == 1
    ref, tol_rot, tol_trans = kscore.seed_trans_reference(f, knn, src, tgt, mask, sigma,
                                                          d["sigma_d"], 10)
    err = (trans.double() - ref).abs()
    assert bool(torch.all(err[..., :3, :3].amax((-1, -2)) <= tol_rot))
    assert bool(torch.all(err[..., :3, 3].amax(-1) <= tol_trans))


@pytest.mark.parametrize("offset_softmax", [True, False])
def test_fused_forward_at_c256_matches_dense(dev, offset_softmax):
    """A two-layer C = 256 model (random weights of seed 0) at N = 4096 fused
    on the card: the split pair of layer kernels by default (the running-max
    attention with ``offset_softmax=False``), the seed k-NN and the seed
    stage on two chunks of 128 channels; the confidence head plain (JAX's
    gate at C = 128). Against the dense path: final_trans atol 1e-3, labels
    > 0.99."""
    model = PointDSC(num_layers=2, num_channels=256, offset_softmax=offset_softmax,
                     device=dev, generator=torch.Generator().manual_seed(0))
    ex = SyntheticPairDataset(num_pairs=1, num_corr=4096, seed=4)[0]
    args = [torch.as_tensor(ex[k])[None].to(dev) for k in ("corr_pos", "src_keypts", "tgt_keypts")]
    with torch.no_grad():
        kernels.reset_launches()
        out = model(*args, fused=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ref = model(*args, fused=False)
    if offset_softmax:
        assert counts["pcn_qkv"] == 2 and counts["attn_mlp_residual"] == 2
        assert counts["fused_encoder_layer"] == 0
    else:
        assert counts["sc_attention_cached"] == 2
    assert counts["seed_knn_exact"] == 1 and counts["seed_hypotheses"] == 1
    assert counts["confidence_head"] == 0
    torch.testing.assert_close(out.final_trans, ref.final_trans, atol=1e-3, rtol=0)
    assert float((out.final_labels == ref.final_labels).float().mean()) > 0.99


@pytest.mark.parametrize("size", [8, 9, 24])
def test_fcgf_conv_traps_on_card(dev, size):
    """VoxelFCGF's two convolutions that differ from ``torch.nn.functional``'s
    defaults (``descriptors/fcgf.py``): the stride-2 ``SAME`` convolution
    (pad (0, 1) on an even size, (1, 1) on an odd one) and the flipped-kernel
    transposed convolution cropped to twice its input, on the card in full
    float32 against the same calls on the CPU (atol 1e-5; TF32 would miss by
    ~1e-3), 3 -> 4 channels."""
    from pointdsc_tpu_torch._device import full_f32_matmul
    from pointdsc_tpu_torch.descriptors import fcgf

    gen = torch.Generator().manual_seed(size)
    x = torch.randn((2, 3, size, size, size), generator=gen)
    down = torch.nn.Conv3d(3, 4, 3, stride=2)
    up = torch.nn.ConvTranspose3d(3, 4, 3, stride=2)
    with full_f32_matmul():
        for fn, mod, shape in ((fcgf.conv_same, down, -(-size // 2)),
                               (fcgf.conv_transpose_same, up, 2 * size)):
            ref = fn(mod, x)
            out = fn(mod.to(dev), x.to(dev))
            assert out.shape == (2, 4, shape, shape, shape)
            torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The rectangular forms of the int8 cache and the cached attentions: a row
# shard of the sequence-parallel encoder (parallel/seq_parallel.py), nq query
# rows over all nk keys.

RECT_SHAPES = [(1, 31), (31, 513), (513, 5000), (5000, 1), (5000, 513)]


def rect_clouds(nq, nk, b, dev, seed=3):
    """Row clouds [b, nq, 3] and column clouds [b, nk, 3] of one synthetic
    scene (the rows the columns' last nq points where nq <= nk, so that the
    square cache of the columns holds them), and the columns' mask (the
    second sample's last 5% padded, at least one key and never all)."""
    m = max(nq, nk)
    ex = [SyntheticPairDataset(num_pairs=b, num_corr=m, seed=seed)[i] for i in range(b)]
    src = torch.as_tensor(np.stack([e["src_keypts"] for e in ex])).to(dev)
    tgt = torch.as_tensor(np.stack([e["tgt_keypts"] for e in ex])).to(dev)
    cols = src[:, :nk].contiguous(), tgt[:, :nk].contiguous()
    rows = src[:, m - nq:].contiguous(), tgt[:, m - nq:].contiguous()
    mask = torch.ones((b, nk), dtype=torch.bool, device=dev)
    if b > 1 and nk > 1:
        mask[1, nk - max(1, nk // 20):] = False
    return rows, cols, mask


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("nq,nk", RECT_SHAPES)
def test_rect_compat_cache(dev, nq, nk, b):
    """The [b, nq, nk] slice in one launch of the rectangular kernel: within
    one count of the plain version on at most 0.1% of entries (the square
    rule), and where the rows are columns too, the square kernel's bytes on
    those rows exactly (the same entry, compat_tile.cuh)."""
    (sr, tr), (sc, tc), mask = rect_clouds(nq, nk, b, dev)
    coef = katt.cache_coef(0.1)
    before = katt.build_compat_cache_int8.launches
    out = katt.build_compat_cache_int8(sr, tr, 0.1, mask=mask, src_cols=sc, tgt_cols=tc)
    assert katt.build_compat_cache_int8.launches == before + 1
    assert out.shape == (b, nq, nk) and out.dtype == torch.int8
    plain = katt.compat_cache_plain(katt.pack_geometry(sr, tr), coef,
                                    katt.pack_geometry(sc, tc, mask))
    diff = (out.int() - plain.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 1).float().mean()) <= 1e-3
    if nq <= nk:
        square = katt._launch_compat_cache(sc, tc, coef)
        assert torch.equal(out, square[:, nk - nq:])


@pytest.mark.parametrize("offset", [True, False])
@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("nq,nk", RECT_SHAPES)
def test_rect_sc_attention(dev, nq, nk, b, c, offset):
    """q [b, nq, c] over k, v [b, nk, c] and the [b, nq, nk] cache through
    ``fused_sc_attention_cached``: one launch of the rectangular kernel
    (counted as the square form's), held to the plain version of the bf16
    inputs at the square kernels' atol = rtol = 2e-3, the offset's bound over
    all nk keys; masked keys carry exactly zero weight. Over few keys a p on a
    bf16 rounding boundary weighs more: at nk = 1 the output is one term,
    which the two versions' roundings of p move by up to 2^-7 relative, so
    rtol is the larger of 2e-3 and 2^-6 / nk."""
    (sr, tr), (sc, tc), mask = rect_clouds(nq, nk, b, dev)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((b, nq, c), generator=gen).to(dev).bfloat16()
    k, v = (torch.randn((b, nk, c), generator=gen).to(dev).bfloat16() for _ in range(2))
    cache = katt.compat_cache_plain(katt.pack_geometry(sr, tr), katt.cache_coef(0.1),
                                    katt.pack_geometry(sc, tc, mask))
    counter = katt.sc_attention_cached_offset if offset else katt.fused_sc_attention_cached
    before = counter.launches
    out = katt.fused_sc_attention_cached(q, k, v, cache, sc, tc, mask=mask,
                                         offset_softmax=offset)
    assert counter.launches == before + 1
    bias = katt.key_bias(mask, b, nk, dev)
    plain = katt.sc_attention_cached_offset_plain if offset else katt.sc_attention_cached_plain
    ref = plain(q, k, v, cache, bias, c=c)
    assert out.shape == (b, nq, c)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=max(2e-3, 2 ** -6 / nk))
    if b > 1 and nk > 1:
        v2 = v.clone()
        v2[1, ~mask[1]] = 1e6
        out2 = katt.fused_sc_attention_cached(q, k, v2, cache, sc, tc, mask=mask,
                                              offset_softmax=offset)
        assert torch.equal(out2, out)


@pytest.mark.parametrize("offset", [True, False])
def test_rect_rows_are_square_rows(dev, offset):
    """A row shard through the rectangular kernel gives the rows of the same
    loop over the whole cloud (within 1e-6: the same loop on the same rows),
    and those are the square call's rows: within 1e-6 for the offset form
    (the square call runs the same loop); for the running max, whose square
    call at C = 128 runs its own kernel (sc_attention_cached.cu: another
    summation order, p rounded against another running max), within that
    kernel's atol = rtol = 2e-3 (test_sc_attention)."""
    n, lo, nq = 2048, 640, 512
    src, tgt, mask, _ = pair(n, dev)
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((B, n, 128), generator=gen).to(dev).bfloat16() for _ in range(3))
    cache = katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    full = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                          offset_softmax=offset)
    part = katt.fused_sc_attention_cached(q[:, lo:lo + nq].contiguous(), k, v,
                                          cache[:, lo:lo + nq].contiguous(), src, tgt,
                                          mask=mask, offset_softmax=offset)
    whole = katt._launch_sc_attention_rect(q, k, v, cache, katt.key_bias(mask, B, n, dev), 128,
                                           offset)
    torch.testing.assert_close(part, whole[:, lo:lo + nq], atol=1e-6, rtol=1e-6)
    tol = 1e-6 if offset else 2e-3
    torch.testing.assert_close(full, whole, atol=tol, rtol=tol)
