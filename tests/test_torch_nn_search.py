"""The registration path's kernels and small linear algebra, the port's plain
versions against the JAX package on the same numpy-seeded float32 inputs:
the nearest-neighbour search (JAX's Pallas kernel in interpret mode), the
symmetric cache build (JAX's triangle + mirror build in interpret mode), ``pairwise_sq_dists``, the Jacobi eigensolvers and the
``method="jacobi"`` Procrustes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.kernels import nn_search as j_nn
from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu.ops import knn as j_knn
from pointdsc_tpu.ops import linalg as j_linalg
from pointdsc_tpu.ops import procrustes as j_proc
from pointdsc_tpu_torch import kernels
from pointdsc_tpu_torch.kernels import nn_search as t_nn
from pointdsc_tpu_torch.kernels import symcache as t_sym
from pointdsc_tpu_torch.ops import knn as t_knn
from pointdsc_tpu_torch.ops import linalg as t_linalg
from pointdsc_tpu_torch.ops import procrustes as t_proc


def clouds(rng, n, m, mask_share):
    """A query and a base cloud in a 2 m cube; the query half near base
    points (small residuals, the ICP case), half anywhere."""
    base = rng.uniform(-1.0, 1.0, size=(m, 3)).astype(np.float32)
    query = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    near = rng.choice(m, n // 2)
    query[: n // 2] = base[near] + rng.normal(scale=0.01, size=(n // 2, 3))
    mask = None if mask_share is None else rng.uniform(size=m) >= mask_share
    return query, base, mask


def d2_matrix(query, base):
    """The [N, M] float32 d2 in the plain version's operations and order."""
    qp = t_nn.pack_points(torch.from_numpy(query))
    bp = t_nn.pack_points(torch.from_numpy(base))
    inner = (qp[:, None, 0] * bp[None, :, 0] + qp[:, None, 1] * bp[None, :, 1]) \
        + qp[:, None, 2] * bp[None, :, 2]
    return ((qp[:, None, 3] + bp[None, :, 3]) - 2.0 * inner).numpy()


# N and M of two base tiles of the TPU kernel (block_k 2048), so its merge
# across tiles runs; a ragged pair besides
@pytest.mark.parametrize("n,m", [(1024, 4096), (300, 517)])
@pytest.mark.parametrize("mask_share", [None, 0.3, 1.0])
def test_nearest_neighbors(rng, n, m, mask_share):
    """d2 within 1e-5 absolute / 1e-4 relative (the JAX kernel's dot is a
    matrix product, the port's three rounded products); the index equal,
    except where the two candidates' d2 lie within 1 ulp of each other. All
    base points masked: index 0 and d2 = 1e30 in both."""
    query, base, mask = clouds(rng, n, m, mask_share)
    jd, ji = j_nn.nearest_neighbors(jnp.asarray(query), jnp.asarray(base),
                                    None if mask is None else jnp.asarray(mask), interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = t_nn.nearest_neighbors(torch.from_numpy(query), torch.from_numpy(base),
                                    None if mask is None else torch.from_numpy(mask))
    td, ti = td.numpy(), ti.numpy()
    assert td.dtype == np.float32 and ti.dtype == np.int64 and ti.shape == (n,)
    np.testing.assert_allclose(td, jd, atol=1e-5, rtol=1e-4)
    if mask_share == 1.0:
        assert (ti == 0).all() and (ji == 0).all()
        assert (td == np.float32(1e30)).all()
        return
    if mask is not None:
        assert mask[ti].all()
    rows = np.nonzero(ti != ji)[0]
    full = d2_matrix(query, base)
    a, b = full[rows, ti[rows]], full[rows, ji[rows]]
    assert (np.abs(a - b) <= np.spacing(np.abs(a))).all()
    assert len(rows) <= 0.01 * n


def test_nearest_neighbors_ties_and_batch(rng):
    """Exact duplicates in the base go to the lower index, as the TPU
    kernel's tile argmin and strict merge give; a batch equals its rows."""
    base = rng.uniform(-1.0, 1.0, size=(64, 3)).astype(np.float32)
    base = np.concatenate([base, base])  # index i and i + 64 are the same point
    query = base[:64] + np.float32(1e-3)
    d2, idx = t_nn.nearest_neighbors(torch.from_numpy(query), torch.from_numpy(base))
    assert (idx.numpy() < 64).all()
    qb = torch.from_numpy(np.stack([query, query[::-1].copy()]))
    bb = torch.from_numpy(np.stack([base, base]))
    mb = torch.from_numpy(np.stack([np.ones(128, bool), np.arange(128) >= 64]))
    d2b, idxb = t_nn.nearest_neighbors(qb, bb, mb)
    for i in range(2):
        d2i, idxi = t_nn.nearest_neighbors(qb[i], bb[i], mb[i])
        assert torch.equal(d2b[i], d2i) and torch.equal(idxb[i], idxi)
    assert (idxb[1] >= 64).all()


def test_nearest_neighbors_refuses():
    """The 2^24 base-size refusal of the TPU kernel's contract (checked before
    anything is read), and shapes the kernel does not take."""
    huge_np = np.broadcast_to(np.zeros(3, np.float32), (1 << 24, 3))
    with pytest.raises(ValueError, match="2\\^24"):
        j_nn.nearest_neighbors(jnp.zeros((4, 3), jnp.float32), huge_np, interpret=True)
    with pytest.raises(ValueError, match="2\\^24"):
        t_nn.nearest_neighbors(torch.zeros(4, 3), torch.zeros(1, 3).expand(1 << 24, 3))
    with pytest.raises(ValueError):
        t_nn.nearest_neighbors(torch.zeros(4, 3), torch.zeros(5, 2))
    with pytest.raises(ValueError):
        t_nn.nearest_neighbors(torch.zeros(4, 3, dtype=torch.float64), torch.zeros(5, 3))
    with pytest.raises(ValueError):
        t_nn.nearest_neighbors(torch.zeros(2, 4, 3), torch.zeros(3, 5, 3))
    with pytest.raises(ValueError):
        t_nn.nearest_neighbors(torch.zeros(4, 3), torch.zeros(5, 3), torch.ones(4, dtype=torch.bool))


def test_nearest_neighbors_cpu_counts_no_launch(rng):
    kernels.reset_launches()
    query, base, _ = clouds(rng, 32, 48, None)
    t_nn.nearest_neighbors(torch.from_numpy(query), torch.from_numpy(base))
    assert kernels.launch_counts()["nearest_neighbors"] == 0


@pytest.mark.parametrize("masked", [False, True])
def test_symmetric_cache_plain(rng, masked):
    """The symmetric build's CPU result against JAX's triangle + mirror
    build (N = 2048: two 1024 tiles, interpret mode): +-1 on at most
    0.1% of entries (both round 127 * compat; an entry within an ulp of a .5
    boundary may round either way). Both are exactly symmetric."""
    n = 2048
    src = rng.uniform(-1.5, 1.5, size=(1, n, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    tgt = (src @ q.T + rng.normal(scale=0.01, size=src.shape)).astype(np.float32)
    tgt[0, n // 2:] = rng.uniform(-1.5, 1.5, size=(n - n // 2, 3))
    mask = (np.arange(n) < n - n // 20)[None] if masked else None
    ref = np.asarray(j_att.build_compat_cache_int8(
        jnp.asarray(src), jnp.asarray(tgt), 0.1,
        mask=None if mask is None else jnp.asarray(mask), interpret=True)).astype(np.int32)
    out = t_sym.build_compat_cache_int8_sym(
        torch.from_numpy(src), torch.from_numpy(tgt), 0.1,
        mask=None if mask is None else torch.from_numpy(mask)).numpy().astype(np.int32)
    assert (out == out.transpose(0, 2, 1)).all() and (ref == ref.transpose(0, 2, 1)).all()
    diff = np.abs(out - ref)
    assert diff.max() <= 1
    assert (diff == 1).mean() <= 1e-3


def test_symmetric_cache_refuses():
    """The wrapper takes any N (the kernel guards a ragged edge), and refuses
    what no build takes: another shape for tgt, points that are not 3-D, a
    mask that is not a bool [B, N]."""
    pts = torch.zeros(1, 512, 3)
    with pytest.raises(ValueError):
        t_sym.build_compat_cache_int8_sym(pts, pts[:, :500].contiguous(), 0.1)
    with pytest.raises(ValueError):
        t_sym.build_compat_cache_int8_sym(pts[..., :2].contiguous(), pts[..., :2].contiguous(), 0.1)
    with pytest.raises(ValueError):
        t_sym.build_compat_cache_int8_sym(pts, pts, 0.1, mask=torch.ones(1, 512))
    assert t_sym.build_compat_cache_int8_sym(pts[:, :500].contiguous(), pts[:, :500].contiguous(),
                                             0.1).shape == (1, 500, 500)


@pytest.mark.parametrize("shape", [((40, 3), (50, 3)), ((2, 30, 5), (2, 20, 5)), ((25, 3), None)])
def test_pairwise_sq_dists(rng, shape):
    """Gram form, clamped at 0: atol 1e-5 (unit-scale points; the two
    matrix products sum in another order)."""
    x = rng.normal(size=shape[0]).astype(np.float32)
    y = None if shape[1] is None else rng.normal(size=shape[1]).astype(np.float32)
    ref = np.asarray(j_knn.pairwise_sq_dists(jnp.asarray(x), None if y is None else jnp.asarray(y)))
    out = t_knn.pairwise_sq_dists(torch.from_numpy(x), None if y is None else torch.from_numpy(y))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert (out.numpy() >= 0).all()


def test_symeig3x3(rng):
    """Eigenvalues atol 1e-5 of the spectrum's scale, eigenvectors equal up to
    1e-4 (the same sweeps on the same matrices give the same signs), and the
    decomposition reconstructs A; a diagonal and a repeated-eigenvalue case."""
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1)
    a[0] = np.diag([3.0, 1.0, 2.0])
    a[1] = np.eye(3)
    wj, vj = (np.asarray(x) for x in j_linalg.symeig3x3(jnp.asarray(a)))
    wt, vt = (x.numpy() for x in t_linalg.symeig3x3(torch.from_numpy(a)))
    scale = np.abs(wj).max(-1, keepdims=True)
    np.testing.assert_allclose(wt / scale, wj / scale, atol=1e-5)
    np.testing.assert_allclose(vt, vj, atol=1e-4)
    np.testing.assert_allclose(vt @ (wt[:, :, None] * vt.transpose(0, 2, 1)), a, atol=1e-4 * scale.max())
    assert (np.diff(wt, axis=-1) >= 0).all()


def test_jacobi_eigh_4x4(rng):
    a = rng.normal(size=(16, 4, 4)).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    wj, vj = (np.asarray(x) for x in j_linalg.jacobi_eigh(jnp.asarray(a)))
    wt, vt = (x.numpy() for x in t_linalg.jacobi_eigh(torch.from_numpy(a)))
    np.testing.assert_allclose(wt, wj, atol=1e-5)
    np.testing.assert_allclose(np.abs((vt * vj).sum(-2)), 1.0, atol=1e-4)


def test_rotation_from_covariance_jacobi(rng):
    """method="jacobi" against JAX's (atol 1e-5), against the port's newton
    method on well-separated spectra (atol 1e-4), and proper rotations."""
    src = rng.normal(size=(8, 50, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    tgt = src @ q.T + rng.normal(scale=0.01, size=src.shape)
    h = np.einsum("bki,bkj->bij", src, tgt).astype(np.float32)
    ref = np.asarray(j_proc.rotation_from_covariance(jnp.asarray(h), method="jacobi"))
    out = t_proc.rotation_from_covariance(torch.from_numpy(h), method="jacobi").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    newton = t_proc.rotation_from_covariance(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(out, newton, atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        t_proc.rotation_from_covariance(torch.from_numpy(h), method="svd")
