"""FPFH normals of points with one or two neighbours in the normal radius
(the port's ``descriptors/fpfh.py::estimate_normals`` against JAX's).

A cloud built from a seed: a dense plane (1500 points) beside 100 isolated
clusters of two and three points, ~5 cm apart, nine in ten of whose points
have one or two neighbours within the 10 cm radius. A one-neighbour covariance is 0, a
two-neighbour covariance has rank 1, and which vector of its null plane the
Jacobi solve returns is decided by rounding. Held bit for bit:

* the covariance (masked mean, centred products) against JAX's jitted
  computation: the mean is a sum over the neighbours in order and the
  products a fused multiply-add chain, as XLA's CPU code forms them;
* the Jacobi eigenvectors on the same covariances against JAX's
  ``symeig3x3`` run op by op (``jax.disable_jit``): each square root
  correctly rounded and each 3 x 3 product an FMA chain.

Inside JAX's jitted ``estimate_normals`` XLA fuses 1 / sqrt(x) into an
approximate reciprocal square root, whose bits depend on the host's vector
instructions; no rounding of the port reproduces it, so the normals of the
rank-deficient points agree with the jitted ones only in part. The last test
prints that share and holds the well-conditioned plane's normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointdsc_tpu.descriptors import fpfh as j_fpfh
from pointdsc_tpu.ops.linalg import symeig3x3 as jax_symeig3x3
from pointdsc_tpu_torch.descriptors import fpfh as t_fpfh
from pointdsc_tpu_torch.ops.linalg import symeig3x3

RADIUS, MAX_NN, PLANE = 0.1, 30, 1500


def sparse_cloud(seed=0):
    rng = np.random.default_rng(seed)
    plane = np.stack([rng.uniform(-1, 1, PLANE), rng.uniform(-1, 1, PLANE),
                      2.0 + 0.002 * rng.normal(size=PLANE)], 1)
    clusters = []
    for i in range(100):
        centre = rng.uniform(-3, 3, 3) + np.array([0.0, 0.0, 5.0])
        clusters += [centre + 0.03 * rng.normal(size=3) for _ in range(2 + i % 2)]
    return np.concatenate([plane, np.array(clusters)]).astype(np.float32)


@jax.jit
def jax_covariance(points):
    """The first lines of JAX's ``estimate_normals``, jitted as there."""
    idx, valid = j_fpfh._chunked_radius_knn(points, MAX_NN, RADIUS)
    neigh = points[idx]
    w = valid.astype(points.dtype)[..., None]
    count = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(neigh * w, axis=1) / count
    centered = (neigh - mean[:, None]) * w
    return jnp.einsum("nki,nkj->nij", centered, centered) / count[..., None]


def test_covariance_matches_jax_bitwise():
    pts = sparse_cloud()
    ref = np.asarray(jax_covariance(jnp.asarray(pts)))
    out = t_fpfh.neighbourhood_covariance(torch.from_numpy(pts), RADIUS, MAX_NN).numpy()
    np.testing.assert_array_equal(out, ref)
    # nine in ten of the clusters' points have one or two neighbours in the
    # radius (232 of 250 with seed 0; a few none, one point four)
    _, valid = t_fpfh._chunked_radius_knn(torch.from_numpy(pts), MAX_NN, RADIUS)
    assert np.isin(valid.sum(1).numpy()[PLANE:], (1, 2)).mean() >= 0.9


def test_jacobi_matches_jax_op_by_op():
    cov = np.asarray(jax_covariance(jnp.asarray(sparse_cloud())))
    with jax.disable_jit():
        w_ref, v_ref = (np.asarray(a) for a in jax_symeig3x3(jnp.asarray(cov)))
    w, v = (a.numpy() for a in symeig3x3(torch.from_numpy(cov.copy())))
    np.testing.assert_array_equal(w, w_ref)
    np.testing.assert_array_equal(v, v_ref)


def test_normals_against_jitted_jax(capsys):
    """The plane's normals within 1e-4 of the jitted JAX function's on
    99.5% of its points; the clusters' share is printed (the module's notes
    say why it is partial)."""
    pts = sparse_cloud()
    ref = np.asarray(j_fpfh.estimate_normals(jnp.asarray(pts), RADIUS, MAX_NN))
    out = t_fpfh.estimate_normals(torch.from_numpy(pts), RADIUS, MAX_NN).numpy()
    agree = np.all(np.abs(out - ref) < 1e-4, axis=1)
    with capsys.disabled():
        print(f"\nnormals within 1e-4 of jitted JAX: plane {agree[:PLANE].mean():.4f}, "
              f"one- and two-neighbour points {agree[PLANE:].mean():.4f}")
    assert agree[:PLANE].mean() >= 0.995
