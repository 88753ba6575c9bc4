"""The port's sequence-parallel encoder (``pointdsc_tpu_torch/parallel/
seq_parallel.py``) against the JAX package's on the same inputs and weights.

The port runs on a mesh of D entries of the CPU device (``[cpu] * D``), JAX
on a ``Mesh`` of D of the suite's 8 virtual CPU devices, at 2 layers,
C = 32, N = 512, D = 2 and 4. On the CPU both fused encoders run their
kernels' plain versions in f32 (JAX's Pallas kernels in interpret mode).
The rectangular int8 cache slice is held to JAX's
``_build_compat_cache_single(geom_cols=...)`` by the square cache's rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pointdsc_tpu.eval.runner import Evaluator as JaxEvaluator
from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu.models.pointdsc import PointDSC as JaxPointDSC
from pointdsc_tpu.parallel import seq_parallel as j_sp
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.eval.runner import Evaluator
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.models.pointdsc import PointDSC
from pointdsc_tpu_torch.parallel import make_mesh, shard_batch
from pointdsc_tpu_torch.parallel import seq_parallel as t_sp
from tests.test_model import make_synthetic_pair

N, LAYERS, C = 512, 2, 32
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    """One planted pair, a JAX model's random variables and the port's model
    holding the same weights; the padded inputs hide the last 96 points."""
    cp, src, tgt, gt, labels = make_synthetic_pair(np.random.default_rng(51), n=N,
                                                   inlier_ratio=0.4)
    jm = JaxPointDSC(in_dim=6, num_layers=LAYERS, num_channels=C, k=20, ratio=0.1)
    args = [a[None] for a in (cp, src, tgt)]
    variables = jax.jit(jm.init)(jax.random.key(0), *(jnp.asarray(a) for a in args))
    # BatchNorm statistics away from (0, 1), so that eval BN is exercised
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.uniform(0.0, 0.2, np.shape(x)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tm = PointDSC(in_dim=6, num_layers=LAYERS, num_channels=C, k=20, ratio=0.1, device="cpu")
    tm.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)),
                       strict=True)
    mask = (np.arange(N) < N - 96)[None]
    return jm, variables, tm, args, mask, gt


def _jax_mesh(d):
    return Mesh(np.asarray(jax.devices()[:d]), ("sp",))


_JITTED = {}


def _jax_sp(fn, jm, variables, jargs, d, mask, **kw):
    """JAX's ``fn(jm, variables, *jargs, mesh, mask=mask, **kw)`` on D
    devices, jitted once per (fn, D, kw) (its shard_map runs op by op
    otherwise, ~15 s a call); an absent mask is all ones, so the masked and
    unmasked cases share one compilation."""
    if mask is None:
        mask = jnp.ones(jargs[0].shape[:2], bool)
    key = (fn, d, tuple(sorted(kw.items())))
    if key not in _JITTED:
        mesh = _jax_mesh(d)
        _JITTED[key] = jax.jit(lambda v, a, b, c, m: fn(jm, v, a, b, c, mesh, mask=m, **kw))
    return _JITTED[key](variables, *jargs, mask)


def _both(args, mask, masked):
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    return (jargs, None if not masked else jnp.asarray(mask),
            targs, None if not masked else torch.from_numpy(mask))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [2, 4])
def test_sp_encode_matches_jax(setup, d, masked):
    """The dense-semantics encoder: the port on [cpu] * D against JAX's on D
    devices, features within 1e-4 (f32 sums in other orders)."""
    jm, variables, tm, args, mask, _ = setup
    jargs, jmask, targs, tmask = _both(args, mask, masked)
    ref = np.asarray(_jax_sp(j_sp.sp_encode, jm, variables, jargs, d, jmask))
    out = t_sp.sp_encode(tm, *targs, [CPU] * d, mask=tmask).numpy()
    rows = slice(None) if not masked else mask[0]
    np.testing.assert_allclose(out[:, rows], ref[:, rows], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [2, 4])
def test_sp_encode_fused_matches_jax(setup, d, masked):
    """The production encoder: the rectangular cache slices and the cached
    attention's plain version on every shard, against JAX's Pallas kernels
    in interpret mode (both f32): features within 1e-3 of their scale (the
    two int8 caches may differ by one count at a few entries), and within
    2% of the dense-semantics encoder (the int8 quantisation, JAX's own
    test's bound)."""
    jm, variables, tm, args, mask, _ = setup
    jargs, jmask, targs, tmask = _both(args, mask, masked)
    ref = np.asarray(_jax_sp(j_sp.sp_encode_fused, jm, variables, jargs, d, jmask))
    out = t_sp.sp_encode_fused(tm, *targs, [CPU] * d, mask=tmask).numpy()
    dense = t_sp.sp_encode(tm, *targs, [CPU] * d, mask=tmask).numpy()
    rows = slice(None) if not masked else mask[0]
    scale = np.abs(ref[:, rows]).max()
    assert np.abs(out[:, rows] - ref[:, rows]).max() <= 1e-3 * scale
    assert np.abs(out[:, rows] - dense[:, rows]).max() <= 0.02 * scale


@pytest.mark.parametrize("d", [2, 4])
def test_rect_cache_matches_jax(setup, d):
    """Each shard's [N/D, N] int8 slice against JAX's rectangular build
    (interpret mode) and against the rows of the port's square cache: equal
    but for at most 0.1% of entries, each off by one count (the gram-form
    products round in other orders)."""
    _, _, _, args, mask, _ = setup
    src, tgt = (torch.from_numpy(a) for a in args[1:])
    m = torch.from_numpy(mask)
    square = t_att.build_compat_cache_int8(src, tgt, 0.1, mask=m)
    geom_cols = j_att.pack_geometry(jnp.asarray(args[1][0]), jnp.asarray(args[2][0]),
                                    jnp.asarray(mask[0]))
    n_loc = N // d
    for i in range(d):
        rows = slice(i * n_loc, (i + 1) * n_loc)
        out = t_att.build_compat_cache_int8(src[:, rows].contiguous(), tgt[:, rows].contiguous(),
                                            0.1, mask=m, src_cols=src, tgt_cols=tgt)
        assert out.shape == (1, n_loc, N) and out.dtype == torch.int8
        geom_rows = j_att.pack_geometry(jnp.asarray(args[1][0, rows]),
                                        jnp.asarray(args[2][0, rows]),
                                        jnp.asarray(mask[0, rows]))
        ref = np.asarray(j_att._build_compat_cache_single(geom_rows, 0.1, interpret=True,
                                                          geom_cols=geom_cols))
        for other in (ref, square[0, rows].numpy()):
            diff = np.abs(out[0].numpy().astype(np.int32) - other.astype(np.int32))
            assert diff.max() <= 1 and (diff == 1).mean() <= 1e-3


def test_rect_attention_plain_is_rows_of_square(setup):
    """A row shard through ``fused_sc_attention_cached`` (q [B, Nq, C] over
    k, v [B, Nk, C]) gives the rows of the square call, both softmax forms,
    within 1e-6 (one f32 result computed on fewer rows)."""
    _, _, _, args, mask, _ = setup
    src, tgt = (torch.from_numpy(a) for a in args[1:])
    m = torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, N, C), generator=gen) for _ in range(3))
    cache = t_att.build_compat_cache_int8(src, tgt, 0.1, mask=m)
    for offset in (True, False):
        full = t_att.fused_sc_attention_cached(q, k, v, cache, src, tgt, mask=m,
                                               offset_softmax=offset)
        rows = slice(128, 256)
        part = t_att.fused_sc_attention_cached(q[:, rows].contiguous(), k, v,
                                               cache[:, rows].contiguous(), src, tgt, mask=m,
                                               offset_softmax=offset)
        np.testing.assert_allclose(part.numpy(), full[:, rows].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fused_encoder", [False, True])
@pytest.mark.parametrize("d", [2, 4])
def test_sp_testing_forward_matches_jax(setup, d, fused_encoder):
    """The whole testing forward with the row-sharded encoder and the dense
    tail, the port against JAX: final transform within 1e-4, labels equal;
    and against the port's own single-device forward."""
    jm, variables, tm, args, mask, _ = setup
    jargs, jmask, targs, tmask = _both(args, mask, True)
    oj = _jax_sp(j_sp.sp_testing_forward, jm, variables, jargs, d, jmask, fused_tail=False,
                 fused_encoder=fused_encoder)
    ot = t_sp.sp_testing_forward(tm, *targs, [CPU] * d, mask=tmask, fused_tail=False,
                                 fused_encoder=fused_encoder)
    np.testing.assert_allclose(ot.final_trans.numpy(), np.asarray(oj.final_trans), atol=1e-4)
    np.testing.assert_array_equal(ot.final_labels.numpy(), np.asarray(oj.final_labels))
    with torch.no_grad():
        single = tm(*targs, mask=tmask, testing=True, fused=fused_encoder)
    np.testing.assert_allclose(ot.final_trans.numpy(), single.final_trans.numpy(), atol=1e-4)


def test_evaluator_with_sp_mesh(setup):
    """``Evaluator(sp_mesh=[cpu] * 2)`` against JAX's Evaluator on a 2-device
    mesh and against the port's Evaluator without a mesh, the fused
    encoder: the same success flag, RE within 0.05 degrees and TE within
    0.01 cm. The pair registers to ~0.05 degrees, and the fused encoders'
    features differ by the rounding of their attentions (the single-device
    one runs the whole-layer kernel's plain version), which moves a
    near-exact rotation by a few hundredths of a degree."""
    jm, variables, tm, args, mask, gt = setup
    n = int(mask.sum())
    sample = {"corr_pos": args[0][0, :n], "src_keypts": args[1][0, :n],
              "tgt_keypts": args[2][0, :n], "gt_trans": gt,
              "gt_labels": np.zeros(n, np.float32)}
    row_sp, _ = Evaluator(tm, fused_attention=True, sp_mesh=[CPU] * 2,
                          device="cpu").run_pair(sample)
    row_single, _ = Evaluator(tm, fused_attention=True, device="cpu").run_pair(sample)
    row_jax, _ = JaxEvaluator(jm, variables, fused_attention=True,
                              sp_mesh=_jax_mesh(2)).run_pair(sample)
    for other in (row_single, row_jax):
        assert row_sp[0] == other[0]
        assert abs(row_sp[1] - other[1]) <= 0.05 and abs(row_sp[2] - other[2]) <= 0.01
    assert row_sp[0] == 1.0


def test_sp_refuses_indivisible_n(setup):
    """N must divide the mesh, as in JAX: a ValueError names both."""
    _, _, tm, args, _, _ = setup
    targs = [torch.from_numpy(a) for a in args]
    for encode in (t_sp.sp_encode, t_sp.sp_encode_fused):
        with pytest.raises(ValueError, match="must divide"):
            encode(tm, *targs, [CPU] * 3)


def test_mesh_helpers():
    """An explicit device list is the mesh; ``shard_batch`` splits axis 0 in
    order and refuses a batch the mesh does not divide."""
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh == [CPU, CPU]
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    shards = shard_batch({"x": x}, mesh)
    np.testing.assert_array_equal(torch.cat([s["x"] for s in shards]).numpy(), x)
    with pytest.raises(ValueError):
        shard_batch({"x": x[:3]}, mesh)
