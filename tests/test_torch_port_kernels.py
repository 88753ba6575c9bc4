"""The plain versions of the port's kernels against the JAX package's
kernel entries (Pallas in interpret mode on the CPU), on the same float32
inputs made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.kernels import conf_mlp as j_conf
from pointdsc_tpu.kernels import nms as j_nms
from pointdsc_tpu.kernels import refine as j_ref
from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu.kernels import scoring as j_score
from pointdsc_tpu.kernels import seed_knn as j_knn
from pointdsc_tpu_torch import kernels
from pointdsc_tpu_torch.kernels import conf_mlp as t_conf
from pointdsc_tpu_torch.kernels import nms as t_nms
from pointdsc_tpu_torch.kernels import refine as t_ref
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.kernels import scoring as t_score
from pointdsc_tpu_torch.kernels import seed_knn as t_knn
from pointdsc_tpu_torch.kernels import sm_loss as t_sm

SIZES = [512, 1024]


@pytest.fixture(autouse=True)
def no_grad():
    """Grad mode is the caller's: these tests run the eval forward without."""
    with torch.no_grad():
        yield


def both(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def pair(rng, n, masked):
    """A synthetic pair: half inliers of a rigid motion, the rest random;
    with `masked`, the last 5% of points are padding."""
    src = rng.uniform(-1.5, 1.5, size=(1, n, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    tgt = src @ q.T + rng.normal(size=3) * 0.3 + rng.normal(size=src.shape) * 0.01
    out = rng.uniform(size=n) < 0.5
    tgt[0, out] = rng.uniform(-1.5, 1.5, size=(int(out.sum()), 3))
    mask = (np.arange(n) < n - n // 20)[None] if masked else None
    return src, tgt, mask


def mask_pair(mask):
    if mask is None:
        return None, None
    return jnp.asarray(mask), torch.from_numpy(mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_compat_cache_int8(rng, n, masked):
    """+-1 on at most 0.1% of entries: both round 127 * compat, and an entry
    within an ulp of a .5 boundary may round either way."""
    src, tgt, mask = pair(rng, n, masked)
    (sj, st), (tj, tt), (mj, mt) = both(src), both(tgt), mask_pair(mask)
    ref = np.asarray(j_att.build_compat_cache_int8(sj, tj, 0.1, mask=mj)).astype(np.int32)
    out = t_att.build_compat_cache_int8(st, tt, 0.1, mask=mt).numpy().astype(np.int32)
    diff = np.abs(out - ref)
    assert diff.max() <= 1
    assert (diff == 1).mean() <= 1e-3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_sc_attention_cached(rng, n, masked):
    """Running-max attention on the same int8 cache, to 1e-5."""
    src, tgt, mask = pair(rng, n, masked)
    (sj, st), (tj, tt), (mj, mt) = both(src), both(tgt), mask_pair(mask)
    cache = np.asarray(j_att.build_compat_cache_int8(sj, tj, 0.1, mask=mj))
    (cj, ct) = both(cache, np.int8)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.normal(size=(1, n, 128))) for _ in range(3))
    ref = j_att.fused_sc_attention_cached(qj, kj, vj, cj, sj, tj, mask=mj,
                                          offset_softmax=False)
    out = t_att.fused_sc_attention_cached(qt, kt, vt, ct, st, tt, mask=mt,
                                          offset_softmax=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_pick_seeds_nms_fused(rng, n, masked):
    src, tgt, mask = pair(rng, n, masked)
    (sj, st), (mj, mt) = both(src), mask_pair(mask)
    cj, ct = both(rng.normal(size=(1, n)))
    ref = np.asarray(j_nms.pick_seeds_nms_fused(sj, cj, 0.1, n // 10, mask=mj))
    out = t_nms.pick_seeds_nms_fused(st, ct, 0.1, n // 10, mask=mt)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("case,subset_runs,full_runs", [
    ("certificate", 1, 0), ("scarce_maxima", 1, 1), ("all_negative", 0, 1)])
def test_pick_seeds_nms_prefiltered(rng, monkeypatch, case, subset_runs, full_runs):
    """prefilter=1024 at N=4096: the certificate branch, its fallback when
    local maxima are scarce, and the positivity precheck's direct route to
    the full kernel all give JAX's indices; each case takes its branch."""
    n, s = 4096, 128
    half = 0.01 if case == "scarce_maxima" else 1.0
    src = rng.uniform(-half, half, size=(1, n, 3))
    lo, hi = (-1.0, -0.01) if case == "all_negative" else (0.01, 1.0)
    (sj, st), (cj, ct) = both(src), both(rng.uniform(lo, hi, size=(1, n)))
    mask = (np.arange(n) < 3500)[None] if case == "certificate" else None
    mj, mt = mask_pair(mask)
    ref = np.asarray(j_nms.pick_seeds_nms_prefiltered(sj, cj, 0.2, s, mask=mj,
                                                      prefilter=1024))
    sizes = []
    flags_fn = t_nms.nms_local_max
    monkeypatch.setattr(t_nms, "nms_local_max",
                        lambda src, *a, **k: sizes.append(src.shape[1]) or flags_fn(src, *a, **k))
    out = t_nms.pick_seeds_nms_prefiltered(st, ct, 0.2, s, mask=mt, prefilter=1024)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (sizes.count(1024), sizes.count(n)) == (subset_runs, full_runs)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_seed_inlier_counts(rng, n, masked):
    src, tgt, mask = pair(rng, n, masked)
    (sj, st), (tj, tt), (mj, mt) = both(src), both(tgt), mask_pair(mask)
    s = n // 10
    trans = np.tile(np.eye(4), (1, s, 1, 1))
    for i in range(s):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        trans[0, i, :3, :3] = q * np.sign(np.linalg.det(q))
        trans[0, i, :3, 3] = rng.normal(size=3) * 0.3
    trj, trt = both(trans)
    ref = np.asarray(j_score.seed_inlier_counts(trj, sj, tj, 0.1, mask=mj))
    out = t_score.seed_inlier_counts(trt, st, tt, 0.1, mask=mt)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n", SIZES)
def test_confidence_head(rng, n):
    """The 128 -> 32 -> 32 -> 1 head against JAX's kernel, to 1e-5. JAX keeps
    a Dense kernel as [in, out], torch.nn.Linear as [out, in]."""
    x = rng.normal(size=(1, n, 128))
    dense = [(rng.normal(size=(i, o)) * 0.2, rng.normal(size=o) * 0.1)
             for i, o in ((128, 32), (32, 32), (32, 1))]
    params = {f"classification_{i}": {"kernel": jnp.asarray(k, jnp.float32),
                                      "bias": jnp.asarray(b, jnp.float32)}
              for i, (k, b) in enumerate(dense)}
    ref = j_conf.confidence_head(jnp.asarray(x, jnp.float32), params)
    weights = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a, np.float32))
               for kb in dense for a in kb]
    out = t_conf.confidence_head(torch.from_numpy(x.astype(np.float32)), *weights)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_seed_knn_exact(rng, n, masked):
    """Exact k = 40 neighbours against JAX's chunk top-k + union kernels:
    the same index set per seed (continuous random features have no ties),
    in descending similarity, never a seed itself or a padded point."""
    f = rng.normal(size=(1, n, 128))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    seeds = rng.choice(n, n // 10, replace=False)[None]
    mask = (np.arange(n) < n - n // 20)[None] if masked else None
    (fj, ft), (mj, mt) = both(f), mask_pair(mask)
    ref = np.asarray(j_knn.seed_knn_exact(fj, jnp.asarray(seeds, jnp.int32), 40, mask=mj))
    out = t_knn.seed_knn_exact(ft, torch.from_numpy(seeds), 40, mask=mt).numpy()
    np.testing.assert_array_equal(np.sort(out, -1), np.sort(ref, -1))
    sim = np.take_along_axis(np.einsum("bsc,bnc->bsn", f[0][seeds], f), out, -1)
    assert (np.diff(sim, axis=-1) <= 0).all()
    assert not (out == seeds[..., None]).any()
    if masked:
        assert mask[0][out].all()


@pytest.mark.parametrize("scene", ["indoor", "kitti"])
def test_fused_post_refinement(rng, scene):
    """The centred Gram-form refinement against JAX's fused one (indoor: thr
    0.10 near the origin; KITTI: thr 1.2 on a cloud ~100 m out). Rotation to
    1e-5; translation to 1e-5 or 4 float32 ulps of the largest coordinate,
    whichever is larger: moving t between the centred and the original frame
    adds and subtracts ~100 m terms, which the two packages round apart."""
    n = 1024
    scale, offset, thr = (1.5, 0.0, 0.10) if scene == "indoor" else (30.0, 100.0, 1.2)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.linalg.det(q))
    t = rng.normal(size=3) * 0.5
    src = rng.uniform(-scale, scale, size=(1, n, 3)) + offset
    tgt = src @ rot.T + t + rng.normal(size=src.shape) * thr * 0.2
    tgt[:, : n // 2] += rng.normal(size=(1, n // 2, 3)) * scale * 0.3
    mask = (np.arange(n) < n - n // 16)[None]
    init = np.eye(4)[None]
    init[0, :3, :3], init[0, :3, 3] = rot, t + thr / 2
    (ij, it), (sj, st), (tj, tt), (mj, mt) = both(init), both(src), both(tgt), mask_pair(mask)
    ref = j_ref.fused_post_refinement(ij, sj, tj, mj, thr, 20)
    out = t_ref.fused_post_refinement(it, st, tt, mt, thr, 20).numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(out[:, :3, :3], ref[:, :3, :3], atol=1e-5)
    ulps = 4 * np.spacing(np.float32(np.abs(np.concatenate([src, tgt])).max()))
    np.testing.assert_allclose(out[:, :, 3], ref[:, :, 3], atol=max(1e-5, ulps))


def test_cpu_tensors_take_the_plain_versions(rng):
    """On CPU tensors no wrapper counts a launch."""
    kernels.reset_launches()
    src, tgt, _ = pair(rng, 256, False)
    st, tt = torch.from_numpy(src.astype(np.float32)), torch.from_numpy(tgt.astype(np.float32))
    cache = t_att.build_compat_cache_int8(st, tt, 0.1)
    q = torch.randn(1, 256, 128)
    t_att.fused_sc_attention_cached(q, q, q, cache, st, tt, offset_softmax=False)
    t_att.fused_sc_attention_cached(q, q, q, cache, st, tt, offset_softmax=True)
    t_nms.nms_local_max(st, torch.randn(1, 256), 0.1)
    t_score.seed_inlier_counts(torch.eye(4).expand(1, 8, 4, 4).contiguous(), st, tt, 0.1)
    head = [torch.zeros(shape) for shape in ((32, 128), (32,), (32, 32), (32,), (1, 32), (1,))]
    t_conf.confidence_head(q, *head)
    t_knn.seed_knn_exact(q, torch.arange(8)[None], 4)
    t_ref.fused_post_refinement(torch.eye(4)[None], st, tt, torch.ones(1, 256, dtype=torch.bool),
                                0.1, 3)
    t_att.fused_sc_attention(q, q, q, st, tt, 0.1)
    geom = t_att.pack_geometry(st, tt)
    out, lse = t_att.sc_attention_forward(q, q, q, geom, 0.1)
    dvec = torch.sum(out * q, dim=-1)
    t_att.sc_attention_backward_dq(q, q, q, geom, lse, dvec, q, 0.1)
    t_att.sc_attention_backward_dkv(q, q, q, geom, lse, dvec, q, 0.1)
    strips = t_sm.pack_labels(torch.ones(1, 256), torch.ones(1, 256, dtype=torch.bool))
    scalars = torch.tensor([[1.0, 0.5, 0.5, 0.0]])
    t_sm.sm_loss_sums(q, strips, scalars)
    t_sm.sm_loss_grads(q, strips, scalars)
    assert len(kernels.WRAPPERS) == 17
    assert kernels.launch_counts() == {name: 0 for name in kernels.WRAPPERS}


def test_wrappers_check_arguments():
    q = torch.zeros(1, 64, 128)
    cache = torch.zeros(1, 64, 64, dtype=torch.int8)
    pts = torch.zeros(1, 64, 3)
    with pytest.raises(ValueError):
        t_att.fused_sc_attention_cached(q.double(), q, q, cache, pts, pts)
    with pytest.raises(ValueError):
        t_att.fused_sc_attention_cached(q, q, q, cache.float(), pts, pts)
    with pytest.raises(ValueError):
        t_att.fused_sc_attention_cached(q, q[:, :32], q, cache, pts, pts)
    with pytest.raises(ValueError):
        t_att.build_compat_cache_int8(pts[..., :2], pts[..., :2], 0.1)
    head = [torch.zeros(shape) for shape in ((32, 128), (32,), (32, 32), (32,), (1, 32), (1,))]
    with pytest.raises(ValueError):
        t_conf.confidence_head(q, *head[:4], torch.zeros(2, 32), head[5])
    with pytest.raises(ValueError):
        t_knn.seed_knn_exact(q, torch.arange(8, dtype=torch.int32)[None], 4)
    with pytest.raises(ValueError):
        t_knn.seed_knn_exact(q, torch.arange(8)[None], 64)
    with pytest.raises(ValueError):
        t_ref.fused_post_refinement(torch.eye(4)[None], pts, pts, torch.ones(1, 64), 0.1, 3)
