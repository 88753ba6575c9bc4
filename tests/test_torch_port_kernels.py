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
from pointdsc_tpu_torch.kernels import nn_search as t_nn
from pointdsc_tpu_torch.kernels import refine as t_ref
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.kernels import scoring as t_score
from pointdsc_tpu_torch.kernels import seed_knn as t_knn
from pointdsc_tpu_torch.kernels import sm_loss as t_sm
from pointdsc_tpu_torch.kernels import symcache as t_sym

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
def test_pick_seeds_nms_prefiltered(rng, case, subset_runs, full_runs):
    """prefilter=1024 at N=4096: the certificate branch, its fallback when
    local maxima are scarce, and the positivity precheck's direct route to
    the full kernel all give JAX's indices; each case takes its branch (the
    subset's launches run when the precheck holds, the full grid's when the
    certificate fails)."""
    n, s = 4096, 128
    half = 0.01 if case == "scarce_maxima" else 1.0
    src = rng.uniform(-half, half, size=(1, n, 3))
    lo, hi = (-1.0, -0.01) if case == "all_negative" else (0.01, 1.0)
    (sj, st), (cj, ct) = both(src), both(rng.uniform(lo, hi, size=(1, n)))
    mask = (np.arange(n) < 3500)[None] if case == "certificate" else None
    mj, mt = mask_pair(mask)
    ref = np.asarray(j_nms.pick_seeds_nms_prefiltered(sj, cj, 0.2, s, mask=mj,
                                                      prefilter=1024))
    out = t_nms.pick_seeds_nms_prefiltered(st, ct, 0.2, s, mask=mt, prefilter=1024)
    np.testing.assert_array_equal(out.numpy(), ref)
    _, pre_ok, cert = t_nms.pick_seeds_gated(st, ct, 0.2, s, mt, 1024)
    assert (int(pre_ok.all()), int(not cert.all())) == (subset_runs, full_runs)


@pytest.mark.parametrize("case,branch", [
    ("certificate", "subset"), ("scarce_maxima", "full"), ("all_negative", "full")])
def test_pick_seeds_gated(rng, case, branch):
    """The prefilter, both decisions as gates of its five launches
    (``pick_seeds_gated``; the gates read on the host on CPU tensors), gives
    JAX's indices in all three branches, over a batch of two whose second
    sample has a masked tail; the precheck and the certificate it returns
    are the branch's, and agree with JAX's top-M values."""
    import jax

    n, s, m = 4096, 128, 1024
    half = 0.01 if case == "scarce_maxima" else 1.0
    src = rng.uniform(-half, half, size=(2, n, 3))
    lo, hi = (-1.0, -0.01) if case == "all_negative" else (0.01, 1.0)
    scores = rng.uniform(lo, hi, size=(2, n))
    mask = np.ones((2, n), bool)
    mask[1, 3500:] = False
    (sj, st), (cj, ct), (mj, mt) = both(src), both(scores), mask_pair(mask)
    ref = np.asarray(j_nms.pick_seeds_nms_prefiltered(sj, cj, 0.2, s, mask=mj, prefilter=m))
    out, pre_ok, cert = t_nms.pick_seeds_gated(st, ct, 0.2, s, mt, m)
    np.testing.assert_array_equal(out.numpy(), ref)
    vals_m = np.asarray(jax.lax.top_k(jnp.where(mj, cj, -jnp.inf), m)[0])
    np.testing.assert_array_equal(pre_ok.numpy(), vals_m[:, s - 1] > 0)
    assert bool(pre_ok.all()) == (case != "all_negative")
    assert bool(cert.all()) == (branch == "subset")


def test_nms_selects_match_jax_top_k(rng):
    """The plain selects: the seed select on int32 total-order keys and the
    top-M select on masked scores against jax.lax.top_k on tied values (+0.0
    above -0.0, ties to the lower index); tau and the precheck from JAX's
    top-M values."""
    import jax

    from pointdsc_tpu_torch.ops.nms import _total_order_key

    vals = np.array([-np.inf, -1.0, -0.0, 0.0, 0.5, 1.0], np.float32)
    x = vals[rng.integers(0, len(vals), size=(2, 3000))]
    xj, xt = both(x)
    for k in (1, 300, 3000):
        ref = np.asarray(jax.lax.top_k(xj, k)[1])
        np.testing.assert_array_equal(t_nms.nms_select(_total_order_key(xt), k).numpy(), ref)
    mask = rng.uniform(size=x.shape) < 0.9
    ranked = jnp.where(jnp.asarray(mask), xj, -jnp.inf)
    vals_m, top = jax.lax.top_k(ranked, 1024)
    idx_m, tau, pre_ok = t_nms.nms_top_m(xt, torch.from_numpy(mask), 1024, 300)
    np.testing.assert_array_equal(idx_m.numpy(), np.sort(np.asarray(top), axis=-1))
    np.testing.assert_array_equal(tau.numpy(), np.asarray(vals_m)[:, -1])
    np.testing.assert_array_equal(pre_ok.numpy(), np.asarray(vals_m[:, 299] > 0))


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
    out = t_conf.confidence_head(torch.from_numpy(x.astype(np.float32)),
                                 t_conf.pack_head_weights(*weights))
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


def knn_expected(sim, seeds, mask, k):
    """Per seed, by hand: the valid candidates by similarity descending, ties
    by index; then the padded ones by index; never the seed itself."""
    out = []
    for i, seed in enumerate(seeds[0]):
        valid = [j for j in np.flatnonzero(mask[0]) if j != seed]
        padded = [j for j in np.flatnonzero(~mask[0]) if j != seed]
        valid.sort(key=lambda j: (-sim[i, j], j))
        out.append((valid + padded)[:k])
    return np.asarray(out)[None]


@pytest.mark.parametrize("masked", [False, True])
def test_seed_knn_ties_in_index_order(masked):
    """One-hot rows over four channels: every similarity is exactly 0 or 1 in
    any summation order, so most candidates tie. The plain version returns
    the other rows of the seed's channel, then the rest, each in index order
    (exactly, no tolerance), as JAX's chunk top-k and union select do."""
    rng = np.random.default_rng(7)
    n, k = 512, 40
    f = np.zeros((1, n, 128), np.float32)
    f[0, np.arange(n), rng.integers(0, 4, size=n)] = 1.0
    seeds = rng.choice(n, n // 10, replace=False)[None]
    mask = (np.arange(n) < n - n // 20)[None] if masked else np.ones((1, n), bool)
    want = knn_expected(f[0][seeds[0]] @ f[0].T, seeds, mask, k)
    (fj, ft), (mj, mt) = both(f), mask_pair(mask if masked else None)
    out = t_knn.seed_knn_exact(ft, torch.from_numpy(seeds), k, mask=mt).numpy()
    ref = np.asarray(j_knn.seed_knn_exact(fj, jnp.asarray(seeds, jnp.int32), k, mask=mj))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ref, want)


def test_seed_knn_fewer_valid_than_k():
    """24 valid points of 512 and k = 40: each seed's valid neighbours come
    first by similarity (continuous random features, no ties), then padded
    points fill the list in index order; the seed itself (one seed is a
    padded point) never appears. Exact against the rule and JAX's kernels."""
    rng = np.random.default_rng(8)
    n, k = 512, 40
    f = rng.normal(size=(1, n, 128))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    mask = np.zeros((1, n), bool)
    mask[0, rng.choice(n, 24, replace=False)] = True
    seeds = np.concatenate([rng.choice(np.flatnonzero(mask[0]), 8, replace=False),
                            np.flatnonzero(~mask[0])[:1]])[None]
    (fj, ft), (mj, mt) = both(f), mask_pair(mask)
    f32 = f.astype(np.float32)[0]
    want = knn_expected(f32[seeds[0]] @ f32.T, seeds, mask, k)
    out = t_knn.seed_knn_exact(ft, torch.from_numpy(seeds), k, mask=mt).numpy()
    ref = np.asarray(j_knn.seed_knn_exact(fj, jnp.asarray(seeds, jnp.int32), k, mask=mj))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ref, want)
    assert not (out == seeds[..., None]).any()


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


def test_post_refinement_far_masked_batch(rng):
    """The plain refinement (the CPU path of the wrapper, whose kernel now
    centres the clouds itself) against JAX's fused refinement on a batch of
    two pairs ~100 m from the origin, threshold 1.2, each with its own mask
    and its padded points set to junk 1 km out. Tolerances as in
    test_fused_post_refinement (4 ulps of the largest valid coordinate for
    the translation). The plain loop's round count means what the kernel's
    means: the last counted round saw no change, so stopping one round
    earlier gives the same transform and two rounds earlier another one."""
    n, thr = 1024, 1.2
    src = rng.uniform(-30.0, 30.0, size=(2, n, 3)) + 100.0
    tgt = np.empty_like(src)
    init = np.tile(np.eye(4), (2, 1, 1))
    for i in range(2):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rot = q * np.sign(np.linalg.det(q))
        t = rng.normal(size=3) * 2.0
        tgt[i] = src[i] @ rot.T + t + rng.normal(size=(n, 3)) * thr * 0.2
        tgt[i, : n // 2] += rng.normal(size=(n // 2, 3)) * 10.0
        init[i, :3, :3], init[i, :3, 3] = rot, t + thr * 0.3
    mask = np.ones((2, n), bool)
    mask[0, rng.permutation(n)[: n // 20]] = False
    mask[1, n - n // 10:] = False
    ulps = 4 * np.spacing(np.float32(np.abs(np.concatenate([src[mask], tgt[mask]])).max()))
    src[~mask], tgt[~mask] = 1000.0, -1000.0
    (ij, it), (sj, st), (tj, tt), (mj, mt) = both(init), both(src), both(tgt), mask_pair(mask)
    ref = np.asarray(j_ref.fused_post_refinement(ij, sj, tj, mj, thr, 20))
    out, rounds = t_ref.fused_post_refinement(it, st, tt, mt, thr, 20, return_iters=True)
    out = out.numpy()
    np.testing.assert_allclose(out[:, :3, :3], ref[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(out[:, :, 3], ref[:, :, 3], atol=max(1e-5, ulps))
    assert rounds.dtype == torch.int32 and bool(((rounds >= 2) & (rounds < 20)).all())
    for i, r in enumerate(rounds.tolist()):
        one = (it[i:i + 1], st[i:i + 1], tt[i:i + 1], mt[i:i + 1], thr)
        assert np.array_equal(t_ref.fused_post_refinement(*one, r - 1)[0].numpy(), out[i])
        assert not np.array_equal(t_ref.fused_post_refinement(*one, r - 2)[0].numpy(), out[i])


def test_cpu_tensors_take_the_plain_versions(rng):
    """On CPU tensors no wrapper counts a launch."""
    kernels.reset_launches()
    src, tgt, _ = pair(rng, 256, False)
    st, tt = torch.from_numpy(src.astype(np.float32)), torch.from_numpy(tgt.astype(np.float32))
    cache = t_att.build_compat_cache_int8(st, tt, 0.1)
    q = torch.randn(1, 256, 128)
    t_att.fused_sc_attention_cached(q, q, q, cache, st, tt, offset_softmax=False)
    t_att.fused_sc_attention_cached(q, q, q, cache, st, tt, offset_softmax=True)
    keys = t_nms.nms_local_max(st, torch.randn(1, 256), 0.1, keys=True)
    t_nms.nms_select(keys, 25)
    t_nms.nms_top_m(torch.randn(1, 256), None, 64, 25)
    t_score.seed_inlier_counts(torch.eye(4).expand(1, 8, 4, 4).contiguous(), st, tt, 0.1)
    head = [torch.zeros(shape) for shape in ((32, 128), (32,), (32, 32), (32,), (1, 32), (1,))]
    t_conf.confidence_head(q, t_conf.pack_head_weights(*head))
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
    t_nn.nearest_neighbors(st[0], tt[0])
    t_sym.build_compat_cache_int8_sym(st, tt, 0.1)
    m = torch.ones(1, 256, dtype=torch.bool)
    seeds = torch.arange(8)[None]
    f = torch.nn.functional.normalize(q, dim=-1)
    t_score.seed_hypotheses(f, seeds, t_knn.seed_knn_exact(f, seeds, 4), st, tt, m,
                            torch.ones(1), 0.1, 0.1, 10)
    t_score.select_hypothesis(torch.eye(4).expand(1, 8, 4, 4).contiguous(), torch.ones(1, 8),
                              seeds, st, tt, 0.1, m)
    assert len(kernels.WRAPPERS) == 23
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
        t_conf.pack_head_weights(*head[:4], torch.zeros(2, 32), head[5])
    with pytest.raises(ValueError):
        t_conf.confidence_head(q, t_conf.pack_head_weights(*head)[:-4])
    with pytest.raises(ValueError):
        t_knn.seed_knn_exact(q, torch.arange(8, dtype=torch.int32)[None], 4)
    with pytest.raises(ValueError):
        t_knn.seed_knn_exact(q, torch.arange(8)[None], 64)
    with pytest.raises(ValueError):
        t_ref.fused_post_refinement(torch.eye(4)[None], pts, pts, torch.ones(1, 64), 0.1, 3)
