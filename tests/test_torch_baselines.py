"""The port's classical baselines (``pointdsc_tpu_torch/baselines/
classical.py``) and native libraries (``pointdsc_tpu_torch/native/``)
against the JAX package's, on the CPU.

Inputs: seeded numpy pairs with a planted rigid motion (half inliers, 1 cm
noise), batch 2 at N = 256, the second sample padded by 56 masked points at
the origin; H = 512 hypotheses. The JAX functions run with 64-bit types
off, as the package runs on its accelerator. RANSAC and GC-RANSAC are held
on JAX's own draws: the port's ``draw_minimal_sets`` is replaced by
``jax.random.randint(key, (b, H, 3), 0, n)``.

Held: SM trans within 1e-4, labels equal; LS within 1e-5; PMC labels equal,
trans within 1e-5; RANSAC labels equal, trans within 1e-4; ICM energies
within 1e-5 relative, labels equal; mincut equal; GC-RANSAC (icm and exact,
also where a sample has fewer than ``knn_k`` valid points) labels equal,
trans within 1e-4; the native max clique against JAX's loader and brute
force; the ``.cpp`` files byte copies of the JAX package's; a build writes
only under ``pointdsc_tpu_torch/_build/``.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pointdsc_tpu import native as j_native  # noqa: E402
from pointdsc_tpu.baselines import classical as jc  # noqa: E402
from pointdsc_tpu_torch import native as t_native  # noqa: E402
from pointdsc_tpu_torch.baselines import classical as tc  # noqa: E402
from tests.test_max_clique import brute_force_max_clique, edges_from_adj  # noqa: E402

N, B, PAD, H = 256, 2, 56, 512


def x32():
    """The JAX package's own mode: 64-bit types off."""
    return jax.enable_x64(False)


def random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def planted_pair(rng, n, inlier_ratio=0.5, noise=0.01, scale=2.0):
    """src, tgt [n, 3] float32 and gt [4, 4]: inliers tgt = R src + t +
    noise, outliers anywhere in the cube."""
    R, t = random_rotation(rng), rng.uniform(-1.0, 1.0, 3)
    src = rng.uniform(0.0, scale, (n, 3))
    tgt = src @ R.T + t + noise * rng.normal(size=(n, 3))
    out = rng.random(n) >= inlier_ratio
    tgt[out] = rng.uniform(-1.0, 1.0 + scale, (int(out.sum()), 3))
    gt = np.eye(4)
    gt[:3, :3], gt[:3, 3] = R, t
    return src.astype(np.float32), tgt.astype(np.float32), gt


# the second sample of FEW has 6 valid points, fewer than GC-RANSAC's knn_k = 8,
# all of them inliers (a registration that is defined)
PADDED, FEW = (N, N - PAD), (N, 6)


def batch(seed=0, valid=PADDED):
    """[B, N, 3] src and tgt and the [B, N] mask: sample b has valid[b]
    points, the rest zeros; half of them inliers, all where fewer than 8."""
    rng = np.random.default_rng(seed)
    src = np.zeros((B, N, 3), np.float32)
    tgt = np.zeros((B, N, 3), np.float32)
    mask = np.zeros((B, N), bool)
    for b, n in enumerate(valid):
        src[b, :n], tgt[b, :n], _ = planted_pair(rng, n, inlier_ratio=0.5 if n >= 8 else 1.0)
        mask[b, :n] = True
    return src, tgt, mask


def jax_draws(key):
    """The port's draw_minimal_sets replaced by JAX's draw from ``key``."""
    def draw(b, h, n, generator, device):
        with x32():
            idx = jax.random.randint(key, (b, h, 3), 0, n)
        return torch.tensor(np.asarray(idx), dtype=torch.int64, device=device)
    return draw


def t_(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_spectral_matching_matches_jax():
    src, tgt, _ = batch(1)
    trans, labels = tc.spectral_matching(*t_(src, tgt), 0.10)
    with x32():
        j_trans, j_labels = jc.spectral_matching(jnp.asarray(src), jnp.asarray(tgt), 0.10)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), atol=1e-4)
    assert labels.sum(-1).tolist() == [int(N * 0.1)] * B


def test_least_squares_fit_matches_jax():
    src, tgt, mask = batch(2)
    rng = np.random.default_rng(2)
    gt_labels = (mask & (rng.random((B, N)) < 0.5)).astype(np.float32)
    trans, labels = tc.least_squares_fit(*t_(src, tgt, gt_labels))
    with x32():
        j_trans, _ = jc.least_squares_fit(jnp.asarray(src), jnp.asarray(tgt),
                                          jnp.asarray(gt_labels))
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), atol=1e-5)
    assert labels is not None and trans.dtype == torch.float32


@pytest.mark.parametrize("seed", [3, 4])
def test_pmc_registration_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src, tgt, _ = planted_pair(rng, N)
    trans, labels = tc.pmc_registration(src, tgt, 0.10, device="cpu")
    with x32():
        j_trans, j_labels = jc.pmc_registration(src, tgt, 0.10)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_allclose(trans, j_trans, atol=1e-5)
    assert trans.shape == (4, 4) and trans.dtype == np.float32 and labels.sum() > N / 3


def test_ransac_registration_matches_jax(monkeypatch):
    src, tgt, mask = batch(5)
    key = jax.random.key(7)
    monkeypatch.setattr(tc, "draw_minimal_sets", jax_draws(key))
    trans, labels = tc.ransac_registration(*t_(src, tgt), None, 0.10, num_hypotheses=H,
                                           mask=torch.as_tensor(mask))
    with x32():
        j_trans, j_labels = jc.ransac_registration(
            jnp.asarray(src), jnp.asarray(tgt), key, 0.10, num_hypotheses=H,
            mask=jnp.asarray(mask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), atol=1e-4)
    assert (labels.numpy()[~mask] == 0).all() and (labels.sum(-1) > 80).all()


def test_chunked_sweep_keeps_the_first_best(monkeypatch):
    """Sweeping the hypotheses in chunks of 1, 7 or all gives one result."""
    src, tgt, mask = batch(6)
    args = (*t_(src, tgt), None, 0.10)
    outs = []
    for elements in (N * B, 7 * N * B, 1 << 24):
        monkeypatch.setattr(tc, "SWEEP_ELEMENTS", elements)
        gen = torch.Generator().manual_seed(0)
        outs.append(tc.ransac_registration(*args[:2], gen, 0.10, num_hypotheses=64,
                                           mask=torch.as_tensor(mask)))
    for trans, labels in outs[1:]:
        assert torch.equal(trans, outs[0][0]) and torch.equal(labels, outs[0][1])


def test_draw_minimal_sets_follows_the_generator():
    a = tc.draw_minimal_sets(2, 100, 37, torch.Generator().manual_seed(3), "cpu")
    b = tc.draw_minimal_sets(2, 100, 37, torch.Generator().manual_seed(3), "cpu")
    assert a.shape == (2, 100, 3) and a.dtype == torch.int64 and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 37


def coherence_inputs(seed, bimodal=True, valid=PADDED):
    """r2, the kNN graph of a padded batch (the GC-RANSAC construction on
    JAX's side) and the mask, as numpy arrays."""
    src, _, mask = batch(seed, valid)
    rng = np.random.default_rng(seed)
    if bimodal:
        r2 = np.where(rng.random((B, N)) < 0.5, rng.uniform(0, 0.5, (B, N)),
                      rng.uniform(1.5, 9.0, (B, N)))
    else:
        r2 = rng.uniform(0.0, 2.0, (B, N))
    with x32():
        d = jc.pairwise_dists(jnp.asarray(src))
        d = jnp.where(jnp.asarray(mask)[:, None, :], d, jnp.inf) + jnp.eye(N) * 1e9
        _, nbr = jax.lax.top_k(-d, 8)
        nbr_valid = jc._take_nbr(jnp.asarray(mask), nbr) & jnp.asarray(mask)[..., None]
    return (r2.astype(np.float32), np.asarray(nbr).astype(np.int64), np.asarray(nbr_valid),
            mask)


@pytest.mark.parametrize("valid", [PADDED, FEW], ids=["padded", "fewer_than_k"])
@pytest.mark.parametrize("bimodal", [True, False])
def test_coherence_icm_matches_jax(bimodal, valid):
    """Also where the self edges of a sample with fewer than k valid points
    vote in the sweeps."""
    r2, nbr, nv, mask = coherence_inputs(8, bimodal, valid)
    E, L = tc.coherence_icm(*t_(r2, nbr, nv, mask), 0.1)
    with x32():
        j_E, j_L = jc.coherence_icm(*map(jnp.asarray, (r2, nbr, nv, mask)), 0.1)
    np.testing.assert_array_equal(L.numpy(), np.asarray(j_L))
    np.testing.assert_allclose(E.numpy(), np.asarray(j_E), rtol=1e-5)


def test_coherence_mincut_matches_jax():
    r2, nbr, nv, mask = coherence_inputs(9, bimodal=False)
    E, L = tc.coherence_mincut(*t_(r2, nbr, nv, mask), 0.1)
    j_E, j_L = jc.coherence_mincut(r2, nbr, nv, mask, 0.1)
    assert E.dtype == torch.float32 and L.dtype == torch.bool
    np.testing.assert_array_equal(E.numpy(), j_E)
    np.testing.assert_array_equal(L.numpy(), j_L)
    # the exact minimum is never above ICM's local one
    E_icm, _ = tc.coherence_icm(*t_(r2, nbr, nv, mask), 0.1)
    assert (E <= E_icm + 1e-4).all()


@pytest.mark.parametrize("minimizer", ["icm", "exact"])
@pytest.mark.parametrize("valid", [PADDED, FEW], ids=["padded", "fewer_than_k"])
def test_gc_ransac_matches_jax(monkeypatch, minimizer, valid):
    """Also where a sample has 6 valid points, fewer than knn_k = 8: each
    lists itself before the masked points, an edge that votes in ICM."""
    src, tgt, mask = batch(10, valid)
    key = jax.random.key(11)
    monkeypatch.setattr(tc, "draw_minimal_sets", jax_draws(key))
    trans, labels = tc.gc_ransac_registration(*t_(src, tgt), None, 0.10, num_hypotheses=H,
                                              mask=torch.as_tensor(mask), minimizer=minimizer)
    with x32():
        j_trans, j_labels = jc.gc_ransac_registration(
            jnp.asarray(src), jnp.asarray(tgt), key, 0.10, num_hypotheses=H,
            mask=jnp.asarray(mask), minimizer=minimizer)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), atol=1e-4)
    assert (labels.numpy()[~mask] == 0).all() and labels[0].sum() > 80


def test_gc_ransac_knn_lists_the_point_itself():
    """A valid point with fewer than knn_k valid others: its valid others,
    then itself, then masked points, ties to the lower index."""
    src = torch.zeros((1, 16, 3))
    src[0, :3] = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [0, 2.0, 0]])
    mask = torch.arange(16)[None] < 3
    d = torch.sqrt(tc.pairwise_sq_dists(src)).masked_fill(~mask[:, None, :], float("inf"))
    d.diagonal(dim1=-2, dim2=-1).add_(1e9)
    nbr = tc._smallest_k(d, 5)
    assert nbr[0, 0].tolist() == [1, 2, 0, 3, 4]
    assert nbr[0, 1].tolist() == [0, 2, 1, 3, 4]


def test_gc_ransac_refuses_unknown_minimizer():
    src = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError, match="minimizer"):
        tc.gc_ransac_registration(src, src, minimizer="bp")


def test_pygc_adapter_raises_import_error():
    pts = np.zeros((4, 3))
    with pytest.raises(ImportError):
        tc.gc_ransac_registration_pygc(pts, pts)


# ------------------------------------------------------------------ native

@pytest.mark.parametrize("p", [0.3, 0.6, 0.9])
def test_max_clique_against_brute_force(p):
    rng = np.random.default_rng(int(p * 10))
    n = 14
    for _ in range(5):
        adj = np.triu(rng.random((n, n)) < p, 1)
        adj = adj | adj.T
        ei, ej = edges_from_adj(adj, n)
        if len(ei) == 0:
            continue
        ours = t_native.max_clique(ei, ej, n)
        assert len(ours) == len(brute_force_max_clique(n, adj))
        for u, v in itertools.combinations(ours.tolist(), 2):
            assert adj[u][v]


def test_max_clique_against_jax_loader():
    """Random graphs whose maximum clique is planted and unique (a 20-clique
    in a sparse graph): the same members from both loaders."""
    rng = np.random.default_rng(12)
    for n in (60, 300, 1000):
        adj = np.triu(rng.random((n, n)) < 0.05, 1)
        planted = rng.choice(n, 20, replace=False)
        for u, v in itertools.combinations(sorted(planted), 2):
            adj[min(u, v), max(u, v)] = True
        ei, ej = np.nonzero(adj)
        ours = np.sort(t_native.max_clique(ei, ej, n))
        np.testing.assert_array_equal(ours, np.sort(j_native.max_clique(ei, ej, n)))
        np.testing.assert_array_equal(ours, np.sort(planted))


def test_mincut_labels_against_jax_loader():
    rng = np.random.default_rng(13)
    n = 200
    ei, ej = rng.integers(0, n, 800), rng.integers(0, n, 800)
    w, c_in, c_out = rng.uniform(0, 0.3, 800), rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    c_in[:5] = np.inf
    e, lab = t_native.mincut_labels(ei, ej, w, c_in, c_out, n)
    j_e, j_lab = j_native.mincut_labels(ei, ej, w, c_in, c_out, n)
    assert e == j_e
    np.testing.assert_array_equal(lab, j_lab)
    assert not lab[:5].any()


def test_native_sources_are_byte_copies():
    for name in ("max_clique.cpp", "maxflow.cpp"):
        with open(os.path.join(ROOT, "pointdsc_tpu", "native", name), "rb") as f:
            ref = f.read()
        with open(os.path.join(ROOT, "pointdsc_tpu_torch", "native", name), "rb") as f:
            assert f.read() == ref, name


def test_native_build_writes_only_under_build(tmp_path):
    """A fresh build (in a new process, a copy of the package whose
    ``_build/`` is empty) writes its two libraries there and nothing into
    ``pointdsc_tpu/native/``."""
    import shutil

    j_native._load_library(), j_native._load_maxflow_library()  # JAX's own, if missing
    jax_dir = os.path.join(ROOT, "pointdsc_tpu", "native")
    before = sorted(os.listdir(jax_dir))
    pkg = tmp_path / "pointdsc_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "pointdsc_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "testdata"))
    code = ("import numpy as np\n"
            "from pointdsc_tpu_torch import native\n"
            "assert native._loaded == {}\n"
            "print(sorted(native.max_clique(np.array([0, 0, 1]), np.array([1, 2, 2]), 3).tolist()))\n"
            "print(native.mincut_labels([0], [1], [0.5], [0.1, 0.9], [0.9, 0.1], 2)[0])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(tmp_path)), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["[0, 1, 2]", "0.7"]
    built = sorted(os.listdir(pkg / "_build"))
    assert len(built) == 2 and built[0].startswith("libmax_clique_") \
        and built[1].startswith("libmaxflow_") and all(b.endswith(".so") for b in built)
    assert sorted(os.listdir(jax_dir)) == before


def test_native_library_name_tracks_source_and_flags(monkeypatch):
    a = t_native.lib_path("maxflow")
    assert os.path.dirname(a) == t_native.BUILD_DIR and a != t_native.lib_path("max_clique")
    monkeypatch.setattr(t_native, "_flags", t_native.build_flags() + ("-g",))
    assert t_native.lib_path("maxflow") != a


def test_native_flags_drop_openmp_only_where_it_cannot_link(monkeypatch, tmp_path):
    """The Makefile's flags where g++ links OpenMP (this machine), and the
    same without -fopenmp where it cannot (a g++ without libgomp)."""
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_native, "_flags", None)
    assert t_native.build_flags() == t_native.CXX_FLAGS
    fake = tmp_path / "gxx"
    fake.write_text(f"#!/bin/sh\ncase \" $* \" in *\" -fopenmp \"*) exit 1;; esac\n"
                    f"exec g++ \"$@\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(t_native, "_flags", None)
    flags = t_native.build_flags()
    assert "-fopenmp" not in flags and flags == tuple(f for f in t_native.CXX_FLAGS
                                                      if f != "-fopenmp")
    assert os.path.exists(t_native.build("max_clique")) and os.listdir(tmp_path) != []
    assert not [n for n in os.listdir(tmp_path) if "probe" in n]


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_native, "_flags", t_native.build_flags() + ("-include", "nope.h"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_native.build("maxflow")
