"""The port's plain ops against the JAX package's, on the same float32
inputs made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.ops import compatibility as j_compat
from pointdsc_tpu.ops import eig as j_eig
from pointdsc_tpu.ops import knn as j_knn
from pointdsc_tpu.ops import linalg as j_linalg
from pointdsc_tpu.ops import nms as j_nms
from pointdsc_tpu.ops import procrustes as j_proc
from pointdsc_tpu.ops import se3 as j_se3
from pointdsc_tpu_torch.ops import compatibility as t_compat
from pointdsc_tpu_torch.ops import eig as t_eig
from pointdsc_tpu_torch.ops import knn as t_knn
from pointdsc_tpu_torch.ops import linalg as t_linalg
from pointdsc_tpu_torch.ops import nms as t_nms
from pointdsc_tpu_torch.ops import procrustes as t_proc
from pointdsc_tpu_torch.ops import se3 as t_se3


def f32(a):
    return np.asarray(a, np.float32)


def both(a):
    """The same float32 array for JAX and for torch."""
    a = f32(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def random_rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def random_trans(rng, batch):
    out = np.tile(np.eye(4), (batch, 1, 1))
    for i in range(batch):
        out[i, :3, :3] = random_rotation(rng)
        out[i, :3, 3] = rng.normal(size=3)
    return out


class TestSE3:
    def test_transform(self, rng):
        pj, pt = both(rng.normal(size=(4, 100, 3)))
        tj, tt = both(random_trans(rng, 4))
        np.testing.assert_allclose(t_se3.transform(pt, tt).numpy(),
                                   np.asarray(j_se3.transform(pj, tj)), atol=1e-5)

    def test_integrate_trans(self, rng):
        rj, rt = both(rng.normal(size=(5, 3, 3)))
        vj, vt = both(rng.normal(size=(5, 3)))
        np.testing.assert_allclose(t_se3.integrate_trans(rt, vt).numpy(),
                                   np.asarray(j_se3.integrate_trans(rj, vj)), atol=1e-6)


class TestLinalg:
    @pytest.mark.parametrize("scale", [1.0, 3e7])
    def test_dominant_eigvec4x4(self, rng, scale):
        a = rng.normal(size=(200, 4, 4)) * scale
        aj, at = both(0.5 * (a + a.transpose(0, 2, 1)))
        lj, vj = j_linalg.dominant_eigvec4x4(aj)
        lt, vt = t_linalg.dominant_eigvec4x4(at)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5 * scale)

    @pytest.mark.parametrize("case", ["zero", "repeated"])
    def test_dominant_eigvec4x4_degenerate(self, case):
        a = np.zeros((2, 4, 4)) if case == "zero" else np.tile(np.eye(4) * 2.0, (2, 1, 1))
        aj, at = both(a)
        lj, vj = j_linalg.dominant_eigvec4x4(aj)
        lt, vt = t_linalg.dominant_eigvec4x4(at)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(vt.numpy(), axis=-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)


class TestProcrustes:
    def test_weighted(self, rng):
        src = rng.normal(size=(20, 40, 3))
        tgt = np.stack([s @ random_rotation(rng).T + rng.normal(size=3) for s in src])
        tgt = tgt + rng.normal(size=tgt.shape) * 0.05
        (sj, st), (tj, tt), (wj, wt) = both(src), both(tgt), both(rng.uniform(size=(20, 40)))
        np.testing.assert_allclose(t_proc.weighted_procrustes(st, tt, wt).numpy(),
                                   np.asarray(j_proc.weighted_procrustes(sj, tj, wj)),
                                   atol=1e-5)

    def test_reflection(self, rng):
        src = rng.normal(size=(1, 30, 3))
        (sj, st), (tj, tt) = both(src), both(-src + rng.normal(size=(1, 30, 3)) * 0.01)
        out = t_proc.weighted_procrustes(st, tt).numpy()
        np.testing.assert_allclose(out, np.asarray(j_proc.weighted_procrustes(sj, tj)),
                                   atol=1e-5)
        assert abs(np.linalg.det(out[0, :3, :3]) - 1.0) < 1e-5

    def test_zero_weights_ignored(self, rng):
        src = rng.normal(size=(1, 60, 3))
        tgt = src @ random_rotation(rng).T + rng.normal(size=3)
        tgt[0, 30:] = rng.normal(size=(30, 3)) * 10
        w = np.concatenate([np.ones(30), np.zeros(30)])[None]
        (sj, st), (tj, tt), (wj, wt) = both(src), both(tgt), both(w)
        np.testing.assert_allclose(t_proc.weighted_procrustes(st, tt, wt).numpy(),
                                   np.asarray(j_proc.weighted_procrustes(sj, tj, wj)),
                                   atol=1e-5)

    def test_rotation_from_covariance_identity(self):
        hj, ht = both(np.eye(3)[None])
        np.testing.assert_allclose(t_proc.rotation_from_covariance(ht).numpy(),
                                   np.asarray(j_proc.rotation_from_covariance(hj)), atol=1e-6)


def test_power_iteration(rng):
    m = rng.uniform(size=(64, 40, 40))
    mj, mt = both(m * m.transpose(0, 2, 1))
    np.testing.assert_allclose(t_eig.power_iteration(mt, 10).numpy(),
                               np.asarray(j_eig.power_iteration(mj, 10)), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_spatial_consistency(rng, masked):
    src = rng.uniform(-1.5, 1.5, size=(2, 300, 3))
    tgt = src + rng.normal(size=src.shape) * 0.05
    (sj, st), (tj, tt) = both(src), both(tgt)
    mask = rng.uniform(size=(2, 300)) < 0.9 if masked else None
    cj, dj = j_compat.spatial_consistency(
        sj, tj, 0.1, mask=None if mask is None else jnp.asarray(mask), return_src_dist=True)
    ct, dt = t_compat.spatial_consistency(
        st, tt, 0.1, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)


class TestPickSeedsNMS:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("sign", ["mixed", "negative"])
    def test_indices_identical(self, rng, masked, sign):
        """Identical indices, order included. All-negative confidences make
        every suppressed key -0.0, so the selection is decided by the
        +-0.0 order and the index tie-break alone."""
        n, s = 400, 60
        src = rng.uniform(-1, 1, size=(2, n, 3))
        scores = rng.normal(size=(2, n))
        if sign == "negative":
            scores = -np.abs(scores) - 0.01
        (sj, st), (cj, ct) = both(src), both(scores)
        mask = np.arange(n)[None].repeat(2, 0) < np.array([[n], [330]])
        mj = jnp.asarray(mask) if masked else None
        mt = torch.from_numpy(mask) if masked else None
        ref = np.asarray(j_nms.pick_seeds_nms(j_knn.pairwise_dists_exact(sj), cj, 0.3, s,
                                              mask=mj))
        out = t_nms.pick_seeds_nms(t_knn.pairwise_dists_exact(st), ct, 0.3, s, mask=mt)
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_signed_zero_and_tie_order(self):
        """jax.lax.top_k puts +0.0 before -0.0 and breaks ties by index."""
        key = np.array([[-0.0, 0.0, -0.0, 0.0, -1.0, 0.0, -0.0, 2.0, 2.0]], np.float32)
        import jax

        ref = np.asarray(jax.lax.top_k(jnp.asarray(key), 9)[1])
        np.testing.assert_array_equal(t_nms.top_k_like_jax(torch.from_numpy(key), 9).numpy(),
                                      ref)
