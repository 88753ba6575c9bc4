"""The port's whole-encoder-layer path and offset attention (their plain
versions, which the CPU runs) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs.

Both sides make the same bf16 casts at the same places (q, k, v where they
are stored, p before p v), so they agree far tighter than the JAX suite's own
2e-2 * scale bound of the fused layer against its per-op path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointdsc_tpu.kernels.encoder_layer as j_el
import pointdsc_tpu_torch.kernels.encoder_layer as t_el
from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu.models.blocks import NonLocalNet as JaxNonLocalNet
from pointdsc_tpu.ops.compatibility import spatial_consistency
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.models.blocks import NonLocalNet

N, C, LAYERS = 256, 64, 2


def setup(rng, n=N, c=C, layers=LAYERS):
    """Encoder, jittered BN affine and statistics (so that folding matters),
    one random pair: tests/test_encoder_layer_kernel.py's recipe."""
    enc = JaxNonLocalNet(in_dim=6, num_layers=layers, num_channels=c)
    corr = rng.normal(size=(1, n, 6)).astype(np.float32)
    src = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    variables = enc.init(jax.random.key(0), jnp.asarray(corr), None,
                         attention_fn=lambda q, k, v, m: v)

    def jitter(tree, scale):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        keys = jax.random.split(jax.random.key(7), len(leaves))
        return treedef.unflatten([leaf + scale * jax.random.normal(k, leaf.shape, leaf.dtype)
                                  for leaf, k in zip(leaves, keys)])

    variables = {
        "params": jitter(variables["params"], 0.05),
        "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.3 * jnp.abs(v) + 0.1,
                                              variables["batch_stats"]),
    }
    tenc = NonLocalNet(in_dim=6, num_layers=layers, num_channels=c)
    tenc.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)),
                         strict=True)
    return enc, variables, tenc.eval(), corr, src, tgt


def mask_of(masked, n=N):
    if not masked:
        return None
    m = np.ones((1, n), bool)
    m[:, n - 40:] = False
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_fused_layers_match_jax_kernels(rng, masked, split, monkeypatch):
    """Two layers through the hook, the one-kernel form and (with
    MAX_FUSED_LAYER_N lowered on both sides) the split pair.

    Tolerance atol = 1e-5 * scale (scale = the largest activation): the f32
    sums run in another order on the two sides, which moves a q, k or v that
    sits on a bf16 rounding boundary by one step (2^-8 relative) and a p
    likewise; each such flip is one term among N in a row's sum. Measured
    here: <= 1.4e-6 * scale in all four cases."""
    if split:
        monkeypatch.setattr(j_el, "MAX_FUSED_LAYER_N", 0)
        monkeypatch.setattr(t_el, "MAX_FUSED_LAYER_N", 0)
    enc, variables, tenc, corr, src, tgt = setup(rng)
    mask = mask_of(masked)
    mj = None if mask is None else jnp.asarray(mask)
    cache = j_att.build_compat_cache_int8(jnp.asarray(src), jnp.asarray(tgt), 0.10, mask=mj)
    want = np.asarray(enc.apply(
        variables, jnp.asarray(corr), None, mask=mj,
        fused_layer_fn=j_el.make_fused_layer_fn(cache, mask=mj, interpret=True)))

    tcache = torch.from_numpy(np.array(cache))
    tm = None if mask is None else torch.from_numpy(mask)
    fold_cache = {}
    with torch.no_grad():
        got = tenc(torch.from_numpy(corr), None, mask=tm,
                   fused_layer_fn=t_el.make_fused_layer_fn(tcache, mask=tm,
                                                           fold_cache=fold_cache)).numpy()
    assert len(fold_cache) == LAYERS
    if masked:
        want, got = want[:, :N - 40], got[:, :N - 40]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_pcn_qkv_matches_jax_first_kernel(rng):
    """The PointCN + QKV kernel alone against the first pallas_call of
    _fused_layer_split_single: h to 1e-5, kscale to rtol 1e-6, and q, k, v
    equal bit for bit in bf16 except where the f32 value before the cast sits
    on a rounding boundary, where they may differ by one bf16 step (allowed: 8
    of 16384 entries per array; measured on this seed: 0 in all three)."""
    enc, variables, tenc, corr, src, tgt = setup(rng, layers=1)
    x = np.asarray(rng.normal(size=(N, C)), np.float32)
    weights = t_el.fold_layer(*tenc.layer_params(0))
    jw = [jnp.asarray(w.numpy()) for w in weights]

    captured = {}
    real = j_el.pl.pallas_call

    def spy(kernel, **kw):
        fn = real(kernel, **kw)

        def run(*args):
            out = fn(*args)
            if kernel is j_el._pcn_qkv_kernel:
                captured["out"] = out
            return out
        return run

    j_el.pl.pallas_call = spy
    try:
        compat = jnp.zeros((N, N), jnp.int8)
        with jax.disable_jit():
            j_el._fused_layer_split_single(jnp.asarray(x), compat, jnp.zeros((8, N), jnp.float32),
                                           tuple(jw), interpret=True)
    finally:
        j_el.pl.pallas_call = real
    hj, qj, kj, vj, ksj = (np.asarray(a.astype(jnp.float32)) for a in captured["out"])

    with torch.no_grad():
        h, q, k, v, kscale = t_el.pcn_qkv(torch.from_numpy(x)[None], weights)
    np.testing.assert_allclose(h[0].numpy(), hj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(kscale.numpy(), ksj.reshape(-1), rtol=1e-6)
    for got, want in ((q, qj), (k, kj), (v, vj)):
        got = got[0].float().numpy()
        differ = got != want
        assert differ.sum() <= 8, int(differ.sum())
        assert np.all(np.abs(got - want)[differ] <= np.abs(want[differ]) * 2.0 ** -7)


def _attention_case(rng, scale, n=256, c=32, n_valid=None):
    src = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    tgt = (src + rng.normal(size=(1, n, 3)) * 0.05).astype(np.float32)
    mask = None if n_valid is None else (np.arange(n) < n_valid)[None]
    mj = None if mask is None else jnp.asarray(mask)
    compat = spatial_consistency(jnp.asarray(src), jnp.asarray(tgt), 0.1, mask=mj)
    cache = np.asarray(jnp.round(compat * 127.0).astype(jnp.int8))
    q, k, v = (rng.normal(size=(1, n, c)).astype(np.float32) for _ in range(3))
    return q * scale, k * scale, v, cache, src, tgt, mask


def _both_attentions(q, k, v, cache, src, tgt, mask):
    mj = None if mask is None else jnp.asarray(mask)
    want = np.asarray(j_att.fused_sc_attention_cached(
        *(jnp.asarray(a) for a in (q, k, v, cache, src, tgt)), mask=mj, block_q=128,
        block_k=128, interpret=True, offset_softmax=True))
    got = t_att.fused_sc_attention_cached(
        *(torch.from_numpy(a) for a in (q, k, v, cache, src, tgt)),
        mask=None if mask is None else torch.from_numpy(mask), offset_softmax=True).numpy()
    return got, want


@pytest.mark.parametrize("masked", [False, True])
def test_offset_attention_matches_jax_kernel(rng, masked):
    """In regime, f32 streams on both sides: atol = rtol = 1e-5."""
    case = _attention_case(rng, 1.0, n_valid=200 if masked else None)
    got, want = _both_attentions(*case)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scale,compare", [(3.0, True), (30.0, False)])
def test_offset_attention_extreme_norms(rng, scale, compare):
    """tests/test_cached_attention.py's first case: at scale 3 the bound sits
    near 50 nats and the result agrees with JAX's (atol 1e-4: exp of
    arguments near -50 amplifies the last bit of the logits); at scale 30 the
    rows are far out of regime and the result must stay finite."""
    got, want = _both_attentions(*_attention_case(rng, scale))
    assert np.isfinite(got).all()
    if compare:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_offset_attention_masked_keys_zero_out_of_regime(rng):
    """Masked keys get exactly zero weight even far out of regime: garbage in
    their v rows never reaches a valid row's output."""
    q, k, v, cache, src, tgt, mask = _attention_case(rng, 30.0, n_valid=160)
    v[:, 160:] = 1e6
    got, want = _both_attentions(q, k, v, cache, src, tgt, mask)
    assert np.isfinite(got).all()
    vmax = float(np.abs(v[0, :160]).max())
    assert np.abs(got[0, :160]).max() <= vmax + 1e-3
    assert np.abs(want[0, :160]).max() <= vmax + 1e-3


def test_fold_cache_follows_the_parameters(rng):
    """The folded weights are reused while the parameters are unchanged and
    rebuilt after an in-place update or load_state_dict."""
    _, _, tenc, _, _, _ = setup(rng, layers=1)
    cache = {}
    first = t_el.folded_weights(*tenc.layer_params(0), cache)
    assert t_el.folded_weights(*tenc.layer_params(0), cache) is first
    with torch.no_grad():
        tenc.PointCN_layer_0.MaskedBatchNorm_0.running_var.mul_(2.0)
    second = t_el.folded_weights(*tenc.layer_params(0), cache)
    assert second is not first and not torch.equal(second[0], first[0])
    tenc.load_state_dict(tenc.state_dict())
    assert t_el.folded_weights(*tenc.layer_params(0), cache) is not second
    assert len(cache) == 1
    for got, want in zip(t_el.folded_weights(*tenc.layer_params(0), None), second):
        assert torch.equal(got, want)


def test_pcn_qkv_with_a_workspace(rng):
    """pcn_qkv given a caller's workspace (as the forward shares one across
    its layers) returns that workspace, holding the tensors it returns
    without one; a workspace of the wrong shape or type is refused."""
    x = torch.from_numpy(np.asarray(rng.normal(size=(2, 96, 16)), np.float32))
    shapes = ((16, 16), (16,), (16, 48), (48,), (16, 8), (8,), (8, 8), (8,), (8, 16), (16,))
    weights = tuple(torch.from_numpy(np.asarray(rng.normal(size=s), np.float32) * 0.3)
                    for s in shapes)
    fresh = t_el.pcn_qkv(x, weights)
    ws = t_el.new_workspace(2, 96, 16, x.device)
    t_el.pcn_qkv(x + 1.0, weights, ws)
    got = t_el.pcn_qkv(x, weights, ws)
    assert all(g is w for g, w in zip(got, ws))
    for g, f in zip(got, fresh):
        assert g.dtype == f.dtype and torch.equal(g, f)
    with pytest.raises(ValueError):
        t_el.pcn_qkv(x, weights, t_el.new_workspace(2, 64, 16, x.device))
    with pytest.raises(ValueError):
        t_el.pcn_qkv(x, weights, ws[:4])


def test_encoder_layer_wrappers_check_arguments():
    x = torch.zeros(1, 64, 16)
    cache = torch.zeros(1, 64, 64, dtype=torch.int8)
    shapes = ((16, 16), (16,), (16, 48), (48,), (16, 8), (8,), (8, 8), (8,), (8, 16), (16,))
    weights = tuple(torch.zeros(s) for s in shapes)
    assert t_el.fused_encoder_layer(x, cache, None, weights).shape == x.shape
    with pytest.raises(ValueError):
        t_el.fused_encoder_layer(x.double(), cache, None, weights)
    with pytest.raises(ValueError):
        t_el.fused_encoder_layer(x, cache.float(), None, weights)
    with pytest.raises(ValueError):
        t_el.fused_encoder_layer(x, cache, None, weights[:-1])
    with pytest.raises(ValueError):
        t_el.pcn_qkv(x, tuple(w.double() for w in weights))
    h, q, k, v, kscale = t_el.pcn_qkv(x, weights)
    with pytest.raises(ValueError):
        t_el.attn_mlp_residual(kscale, q.float(), k, v, cache, None, h, weights)
    with pytest.raises(ValueError):
        t_el._check_kernel_size(500, 128)
    t_el._check_kernel_size(512, 192)  # any width: padded to 256 channels, the MLP's 96 to 128
    wide = tuple(torch.zeros(tuple(d * 12 for d in s)) for s in shapes)  # C = 192
    assert [tuple(w.shape) for w in t_el.pad_layer_weights(wide, 192)] == [
        (256, 256), (256,), (256, 768), (768,), (256, 128), (128,), (128, 128), (128,),
        (128, 256), (256,)]


@pytest.mark.parametrize("masked", [False, True])
def test_half_precision_encoder_matches_jax(rng, masked):
    """Two layers op by op with ``compute_dtype`` bf16 (the half-precision
    encoder: bf16 Dense products and bias adds, the BatchNorm affine computed
    in f32 and applied in bf16, the offset attention on bf16 q, k, v) against
    the JAX encoder with the same ``compute_dtype`` around its offset
    attention kernel in interpret mode.

    Tolerance: one bf16 step of the largest activation (2^-8 * scale), and
    more than 99% of the entries equal bit for bit. The two frameworks' bf16
    products accumulate in f32 in another order, so a value on a rounding
    boundary lands one of its own steps away and the next Dense carries that
    on. Measured: largest difference 0.27 steps, 99.7% of the entries equal.
    A Dense that rounds once instead of twice (product, then bias add) leaves
    ~60% equal and moves the largest difference above 2 steps."""
    enc, variables, tenc, corr, src, tgt = setup(rng)
    mask = mask_of(masked)
    mj = None if mask is None else jnp.asarray(mask)
    sj, tj = jnp.asarray(src), jnp.asarray(tgt)
    cache = j_att.build_compat_cache_int8(sj, tj, 0.10, mask=mj)
    want = enc.clone(compute_dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(corr), None, mask=mj,
        attention_fn=lambda q, k, v, m: j_att.fused_sc_attention_cached(
            q, k, v, cache, sj, tj, mask=mj, block_q=128, block_k=128, interpret=True))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))

    tcache = torch.from_numpy(np.array(cache))
    ts, tt = torch.from_numpy(src), torch.from_numpy(tgt)
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = tenc(torch.from_numpy(corr), None, mask=tm, compute_dtype=torch.bfloat16,
                   attention_fn=lambda q, k, v, m: t_att.fused_sc_attention_cached(
                       q.contiguous(), k.contiguous(), v.contiguous(), tcache, ts, tt, mask=tm))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if masked:
        want, got = want[:, :N - 40], got[:, :N - 40]
    step = 2.0 ** -8 * np.abs(want).max()
    diff = np.abs(got - want)
    np.testing.assert_allclose(got, want, atol=step, rtol=0)
    assert (diff == 0).mean() > 0.99
