"""The port's CUDA kernels, through their public wrappers, against their
plain versions on the card, at ragged sizes and batch 2 (chip_smoke.py holds
them at the main path's N = 5120, batch 1). Every test here needs a CUDA
card and skips without one. On a machine with a card (``--noconftest``: the
suite's conftest imports JAX, which the card's machine need not have):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from pointdsc_tpu_torch import kernels, load_pretrained
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.kernels import conf_mlp as kconf
from pointdsc_tpu_torch.kernels import encoder_layer as kenc
from pointdsc_tpu_torch.kernels import nms as knms
from pointdsc_tpu_torch.kernels import refine as kref
from pointdsc_tpu_torch.kernels import sc_attention as katt
from pointdsc_tpu_torch.kernels import scoring as kscore
from pointdsc_tpu_torch.kernels import seed_knn as kknn

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


@pytest.mark.parametrize("n", [1000, 2048])
def test_compat_cache(dev, n):
    """+-1 on at most 0.1% of entries: the kernel's FMAs and cuBLAS round the
    gram-form distances differently, so an entry near a .5 boundary may round
    either way."""
    src, tgt, mask, _ = pair(n, dev)
    plain = katt.compat_cache_plain(katt.pack_geometry(src, tgt, mask), katt.cache_coef(0.1))
    diff = (katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask).int() - plain.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 1).float().mean()) <= 1e-3


@pytest.mark.parametrize("n", [1000, 2048])
def test_sc_attention(dev, n):
    """atol = rtol = 1e-4 on the same cache: f32 throughout, the flash loop
    sums keys tile by tile with a rescale per tile."""
    src, tgt, mask, _ = pair(n, dev)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((B, n, 128), generator=gen).to(dev) for _ in range(3))
    geom = katt.pack_geometry(src, tgt, mask)
    cache = katt.compat_cache_plain(geom, katt.cache_coef(0.1))
    out = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask,
                                         offset_softmax=False)
    ref = katt.sc_attention_cached_plain(q, k, v, cache, geom[:, 8].contiguous())
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


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


def layer_case(n, dev, masked, seed=3):
    """x, cache, kbias and folded weights of one layer at C = 128, B = 2. The
    q and k projections are scaled so that the logits have a standard
    deviation of ~3 (a sharp softmax, offsets near 40 nats: in regime)."""
    src, tgt, mask, _ = pair(n, dev)
    gen = torch.Generator().manual_seed(seed)
    c = 128

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
    weights = kenc.fold_layer(pcn, nl)
    x = rnd(B, n, c)
    cache = katt.build_compat_cache_int8(src, tgt, 0.1, mask=mask)
    kbias = katt.key_bias(mask, B, n, dev) if masked else None
    return x, cache, kbias, weights


def assert_bf16_equal_but_boundaries(got, want, max_share=1e-3):
    """bf16 arrays equal bit for bit except where the f32 pre-image sat on a
    rounding boundary (the two versions sum 128 products in another order):
    those differ by one bf16 step."""
    diff = (got.float() - want.float()).abs()
    step = want.float().abs().clamp_min(1e-30) * 2.0 ** -7
    assert bool((diff <= step).all())
    assert float((diff > 0).float().mean()) <= max_share


@pytest.mark.parametrize("n", [512, 1024])
def test_pcn_qkv(dev, n):
    """h atol = rtol = 1e-5 (f32 dot products of 128 terms in another order);
    q, k, v equal in bf16 except at rounding boundaries (<= 0.1% of entries,
    by one step); kscale rtol 1e-5."""
    x, _, _, weights = layer_case(n, dev, False)
    h, q, k, v, kscale = kenc.pcn_qkv(x, weights)
    hp, qp, kp, vp, ksp = kenc.pcn_qkv_plain(x, weights)
    torch.testing.assert_close(h, hp, atol=1e-5, rtol=1e-5)
    for got, want in ((q, qp), (k, kp), (v, vp)):
        assert_bf16_equal_but_boundaries(got, want)
    torch.testing.assert_close(kscale, ksp, atol=0, rtol=1e-5)


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
    """Wrong dtype, C != 128, an N the encoder-layer kernels do not take."""
    x, cache, kbias, weights = layer_case(512, dev, True)
    with pytest.raises(ValueError):
        kenc.fused_encoder_layer(x.double(), cache, kbias, weights)
    with pytest.raises(ValueError):
        kenc.fused_encoder_layer(x[:, :500].contiguous(), cache[:, :500, :500].contiguous(),
                                 kbias[:, :500].contiguous(), weights)
    with pytest.raises(ValueError):
        kenc.pcn_qkv(x[:, :500].contiguous(), weights)
    with pytest.raises(ValueError):
        kenc.pcn_qkv(x[..., :64].contiguous(), weights)
    h, q, k, v, kscale = kenc.pcn_qkv(x, weights)
    with pytest.raises(ValueError):
        kenc.attn_mlp_residual(kscale, q.float(), k, v, cache, kbias, h, weights)
    with pytest.raises(ValueError):
        kenc.attn_mlp_residual(kscale, q, k, v, cache.float(), kbias, h, weights)
    src, tgt, mask, _ = pair(512, dev)
    q64 = torch.randn((B, 512, 64), device=dev)
    with pytest.raises(ValueError):
        katt.fused_sc_attention_cached(q64, q64, q64, cache, src, tgt, mask=mask)
    with pytest.raises(ValueError):
        katt.fused_sc_attention_cached(x.half(), x.half(), x.half(), cache, src, tgt, mask=mask)


@pytest.mark.parametrize("n", [1000, 2048])
def test_confidence_head(dev, n):
    """atol = rtol = 1e-5: f32 dot products of 128 and 32 terms summed in
    another order than cuBLAS's."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((B, n, 128), generator=gen).to(dev)
    w = [torch.randn(shape, generator=gen).to(dev) * 0.2
         for shape in ((32, 128), (32,), (32, 32), (32,), (1, 32), (1,))]
    torch.testing.assert_close(kconf.confidence_head(x, *w), kconf.confidence_head_plain(x, *w),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1000, 2048])
def test_nms_flags(dev, n):
    """Equal except on queries with a key at |d2 - R^2| < 1e-5, where the two
    roundings of d2 may fall on either side of the radius."""
    src, _, mask, _ = pair(n, dev)
    scores = torch.randn((B, n), generator=torch.Generator().manual_seed(2)).to(dev)
    geom = knms.pack_nms_geometry(src, scores, mask)
    r2 = knms.radius_sq(0.1)
    flags = knms.nms_local_max(src, scores, 0.1, mask=mask)
    ref = knms.nms_local_max_plain(geom, r2)
    xyz = geom[:, 0:3]
    d2 = (geom[:, 3, :, None] + geom[:, 3, None, :] - 2.0 * (xyz.transpose(1, 2) @ xyz)).clamp(0)
    near = torch.any((d2 - r2).abs() < 1e-5, dim=-1)
    assert not bool(((flags != ref) & ~near).any())
    assert 0 < float(flags.sum()) < B * n


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


@pytest.mark.parametrize("n", [1000, 2048])
def test_seed_knn(dev, n):
    """The kernel's neighbour sets against the plain sort, near ties aside."""
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
    ref = kscore.seed_inlier_counts_plain(kscore.pack_scoring_trans(trans),
                                          kscore.pack_scoring_points(src, tgt, mask), t2)
    pred = torch.einsum("bsij,bnj->bsni", trans[:, :, :3, :3], src) + trans[:, :, None, :3, 3]
    res2 = torch.sum((pred - tgt[:, None]) ** 2, dim=-1)
    near = torch.sum(((res2 - t2).abs() < 1e-5) & mask[:, None, :], dim=-1)
    assert bool(torch.all((counts - ref).abs() <= near))
    assert float(counts.sum()) > 0


@pytest.mark.parametrize("n", [1000, 2048])
def test_post_refinement(dev, n):
    """atol 1e-4 on the refined transform: the kernel sums the Gram terms in
    another order than the plain einsums, and solves in the same f32 closed
    form."""
    src, tgt, mask, gt = pair(n, dev)
    init = gt.clone()
    init[:, :3, 3] += 0.03
    out, iters = kref.fused_post_refinement(init, src, tgt, mask, 0.1, 20, return_iters=True)
    ref = kref.fused_post_refinement_plain(init, src, tgt, mask, 0.1, 20)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert bool(((iters >= 1) & (iters <= 20)).all())


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
    kconf.confidence_head(q, *w)
    knms.nms_local_max(src, q[..., 0].contiguous(), 0.1, mask=mask)
    seeds = torch.arange(51, device=dev).expand(B, 51).contiguous()
    kknn.seed_knn_exact(torch.nn.functional.normalize(q, dim=-1), seeds, 8, mask=mask)
    kscore.seed_inlier_counts(gt[:, None].contiguous(), src, tgt, 0.1, mask=mask)
    kref.fused_post_refinement(gt, src, tgt, mask, 0.1, 20)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts.pop("compat_cache_int8") == 2  # this test's and layer_case's
    assert counts == {name: 1 for name in counts}
    q64 = torch.randn((B, 512, 64), device=dev)
    with pytest.raises(ValueError):
        katt.fused_sc_attention_cached(q64, q64, q64, cache, src, tgt, mask=mask,
                                       offset_softmax=False)


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
