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
    out = katt.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=mask)
    ref = katt.sc_attention_cached_plain(q, k, v, cache, geom[:, 8].contiguous())
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


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
    katt.fused_sc_attention_cached(q, q, q, cache, src, tgt, mask=mask)
    w = [torch.zeros(shape, device=dev) for shape in ((32, 128), (32,), (32, 32), (32,),
                                                       (1, 32), (1,))]
    kconf.confidence_head(q, *w)
    knms.nms_local_max(src, q[..., 0].contiguous(), 0.1, mask=mask)
    seeds = torch.arange(51, device=dev).expand(B, 51).contiguous()
    kknn.seed_knn_exact(torch.nn.functional.normalize(q, dim=-1), seeds, 8, mask=mask)
    kscore.seed_inlier_counts(gt[:, None].contiguous(), src, tgt, 0.1, mask=mask)
    kref.fused_post_refinement(gt, src, tgt, mask, 0.1, 20)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {name: 1 for name in kernels.WRAPPERS}
    q64 = torch.randn((B, 512, 64), device=dev)
    with pytest.raises(ValueError):
        katt.fused_sc_attention_cached(q64, q64, q64, cache, src, tgt, mask=mask)


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
