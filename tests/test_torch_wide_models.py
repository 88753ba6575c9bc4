"""Models wider than the kernels' 128 channels, and with more seed neighbours
than the hypotheses kernel's 128 threads, on the CPU, against JAX.

- the port's fused eval forward (its plain versions here) against JAX's
  fused forward (its kernels in interpret mode, as tests/test_fused_model.py
  runs it) on the same numpy inputs and the weights carried across by
  ``compat/weights.py``: two layers, 256 points, or 200 padded to 256, at
  C = 192 with k = 16 and at C = 128 with k = 160; final_trans atol 1e-3,
  labels > 0.99, the seeds equal to JAX's NMS on JAX's confidences;
- the card path's padding of a C = 192 model to two chunks of 128 channels
  (``pad_channels``, ``pad_layer_weights``: the message MLP's 96 to 128):
  each kernel's plain version on the padded operands, with the scale
  constants of the model's own width, against the same plain version
  unpadded, atol 1e-6, the padded channels zero.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_port_cuda.py (``test_wide_*``, k above 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.models import PointDSC as JaxPointDSC
from pointdsc_tpu.ops.knn import pairwise_dists_exact
from pointdsc_tpu.ops.nms import pick_seeds_nms
from pointdsc_tpu_torch import PointDSC
from pointdsc_tpu_torch.compat.weights import from_flax_variables
from pointdsc_tpu_torch.kernels import _check
from pointdsc_tpu_torch.kernels import encoder_layer as t_el
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.kernels import seed_knn as t_knn
from pointdsc_tpu_torch.kernels import sm_loss as t_sm
from tests.test_model import make_synthetic_pair

N, C_WIDE = 256, 192
C_PAD = _check.padded_width(C_WIDE)


@pytest.fixture(autouse=True)
def no_grad():
    """Grad mode is the caller's: these tests run the eval forward without."""
    with torch.no_grad():
        yield


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c,k", [(C_WIDE, 16), (128, 160)])
def test_fused_model_matches_jax(c, k, masked):
    """Two layers, ratio 0.1, 256 points (or 200 padded to 256), random JAX
    weights of seed 0 carried across: the port's fused forward against JAX's
    at tests/test_fused_model.py's tolerance, and the same NMS seeds."""
    rng = np.random.default_rng(0)
    jm = JaxPointDSC(in_dim=6, num_layers=2, num_channels=c, k=k, ratio=0.1)
    n_real = 200 if masked else N
    cp, src, tgt, _, _ = make_synthetic_pair(rng, n=n_real, inlier_ratio=0.6)
    arrs = [np.concatenate([a, np.zeros((N - n_real,) + a.shape[1:], a.dtype)])[None]
            for a in (cp, src, tgt)]
    mask = (np.arange(N) < n_real)[None]
    variables = jm.init(jax.random.key(0), *(jnp.asarray(a) for a in arrs),
                        mask=jnp.asarray(mask))
    out_j = jm.apply(variables, *(jnp.asarray(a) for a in arrs), mask=jnp.asarray(mask),
                     testing=True, fused_attention=True)
    tm = PointDSC(in_dim=6, num_layers=2, num_channels=c, k=k, ratio=0.1, device="cpu")
    tm.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))),
                       strict=True)
    out_t = tm(*(torch.from_numpy(a) for a in arrs), mask=torch.from_numpy(mask), fused=True)
    np.testing.assert_allclose(out_t.final_trans.numpy(), np.asarray(out_j.final_trans),
                               atol=1e-3)
    assert (out_t.final_labels.numpy() == np.asarray(out_j.final_labels)).mean() > 0.99
    seeds_j = pick_seeds_nms(pairwise_dists_exact(jnp.asarray(arrs[1])), out_j.confidence,
                             jm.nms_radius, max(1, int(N * jm.ratio)), mask=jnp.asarray(mask))
    np.testing.assert_array_equal(out_t.seeds.numpy(), np.asarray(seeds_j))


def _layer(seed, c=C_WIDE, n=128):
    """x, ``fold_layer``'s ten arrays, the int8 cache and the key bias of one
    C-wide layer (the last 8 points masked)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def bn(ch):
        return (1.0 + rnd(ch, scale=0.1), rnd(ch, scale=0.1), rnd(ch, scale=0.1),
                1.0 + rnd(ch, scale=0.1).abs())

    w = c ** -0.5
    pcn = (rnd(c, c, scale=w), rnd(c, scale=0.1), bn(c))
    nl = (rnd(c, c, scale=w), rnd(c, scale=0.1), rnd(c, c, scale=w), rnd(c, scale=0.1),
          rnd(c, c, scale=w), rnd(c, scale=0.1), rnd(c // 2, c, scale=w), rnd(c // 2, scale=0.1),
          bn(c // 2), rnd(c // 2, c // 2, scale=w), rnd(c // 2, scale=0.1), bn(c // 2),
          rnd(c, c // 2, scale=w), rnd(c, scale=0.1))
    src, tgt = rnd(1, n, 3), rnd(1, n, 3)
    mask = torch.ones((1, n), dtype=torch.bool)
    mask[:, n - 8:] = False
    cache = t_att.build_compat_cache_int8(src, tgt, 0.5, mask=mask)
    return rnd(1, n, c), t_el.fold_layer(pcn, nl), cache, t_att.key_bias(mask, 1, n, src.device)


def _close_and_zero_padded(got, want):
    torch.testing.assert_close(_check.unpad_channels(got, C_WIDE), want, atol=1e-6, rtol=0)
    assert not bool(got[..., C_WIDE:].any())


@pytest.mark.parametrize("part", ["one_launch", "pcn_qkv", "attn_mlp"])
def test_encoder_layer_padding_to_256_is_exact(part):
    """The encoder-layer kernels' functions on x and the ten folded arrays of
    a C = 192 layer padded to 256 channels (q, k, v in their own thirds, the
    message MLP's 96 to 128), with 1/sqrt(192), against the unpadded plain
    versions: the real channels within 1e-6, the padded ones zero."""
    x, w, cache, kbias = _layer(4)
    wp = t_el.pad_layer_weights(w, C_WIDE)
    assert t_el.mlp_width(C_WIDE) == 128
    assert [tuple(a.shape) for a in wp] == [tuple(a.shape) for a in _layer(4, c=256)[1]]
    xp = _check.pad_channels(x)
    assert xp.shape[-1] == C_PAD
    if part == "one_launch":
        _close_and_zero_padded(t_el.fused_layer_plain(xp, cache, kbias, wp, c=C_WIDE),
                               t_el.fused_layer_plain(x, cache, kbias, w))
    elif part == "pcn_qkv":
        got, want = t_el.pcn_qkv_plain(xp, wp, c=C_WIDE), t_el.pcn_qkv_plain(x, w)
        for g, r in zip(got[:4], want[:4]):
            _close_and_zero_padded(g.float(), r.float())
        torch.testing.assert_close(got[4], want[4], atol=1e-6, rtol=0)
    else:
        h, q, k, v, kscale = t_el.pcn_qkv_plain(x, w)
        got = t_el.attn_mlp_residual_plain(kscale, *(_check.pad_channels(a) for a in (q, k, v)),
                                           cache, kbias, _check.pad_channels(h), wp, c=C_WIDE)
        _close_and_zero_padded(got, t_el.attn_mlp_residual_plain(kscale, q, k, v, cache, kbias,
                                                                 h, w))


def _qkv(seed, n=128):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((2, n, C_WIDE), generator=gen) for _ in range(3))
    src, tgt = torch.randn((2, n, 3), generator=gen), torch.randn((2, n, 3), generator=gen)
    mask = torch.ones((2, n), dtype=torch.bool)
    mask[1, n - 16:] = False
    return q, k, v, src, tgt, mask


@pytest.mark.parametrize("form", ["running_max", "offset", "nocache"])
def test_eval_attention_padding_to_256_is_exact(form):
    """The three eval attentions' plain versions on bf16 q, k, v padded to
    256 channels with the scale of C = 192, against the unpadded ones."""
    q, k, v, src, tgt, mask = _qkv(1)
    qh, kh, vh = q.bfloat16(), k.bfloat16(), v.bfloat16()
    qp, kp, vp = (_check.pad_channels(t) for t in (qh, kh, vh))
    geom = t_att.pack_geometry(src, tgt, mask)
    cache = t_att.compat_cache_plain(geom, t_att.cache_coef(0.5))
    bias = geom[:, 8].contiguous()
    if form == "running_max":
        got = t_att.sc_attention_cached_plain(qp, kp, vp, cache, bias, c=C_WIDE)
        want = t_att.sc_attention_cached_plain(qh, kh, vh, cache, bias)
    elif form == "offset":
        got = t_att.sc_attention_cached_offset_plain(qp, kp, vp, cache, bias, c=C_WIDE)
        want = t_att.sc_attention_cached_offset_plain(qh, kh, vh, cache, bias)
    else:
        got = t_att.sc_attention_nocache_plain(qp, kp, vp, geom, 0.5, c=C_WIDE)
        want = t_att.sc_attention_nocache_plain(qh, kh, vh, geom, 0.5)
    _close_and_zero_padded(got, want)


def test_trainable_attention_padding_to_256_is_exact():
    """The trainable attention's out, LSE and three gradients on operands
    padded to 256 channels (with 1/sqrt(192)) against the unpadded ones."""
    q, k, v, src, tgt, mask = _qkv(2)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    geom = t_att.pack_geometry(src, tgt, mask)
    qp, kp, vp, dp = (_check.pad_channels(t) for t in (q, k, v, d_out))
    out, lse = t_att.sc_attention_forward_plain(q, k, v, geom, 0.5)
    out_p, lse_p = t_att.sc_attention_forward_plain(qp, kp, vp, geom, 0.5, c=C_WIDE)
    _close_and_zero_padded(out_p, out)
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=0)
    dvec = torch.sum(d_out * out, dim=-1)
    grads = t_att.sc_attention_backward_plain(q, k, v, geom, lse, dvec, d_out, 0.5)
    grads_p = t_att.sc_attention_backward_plain(qp, kp, vp, geom, lse, dvec, dp, 0.5, c=C_WIDE)
    for g, gp in zip(grads, grads_p):
        _close_and_zero_padded(gp, g)


def test_sm_loss_and_seed_knn_padding_to_256_are_exact():
    """The SM loss's sums and gradients and the seed k-NN's neighbours on
    features padded to 256 channels against the unpadded ones."""
    gen = torch.Generator().manual_seed(5)
    f = torch.nn.functional.normalize(torch.randn((2, 128, C_WIDE), generator=gen), dim=-1)
    mask = torch.ones((2, 128), dtype=torch.bool)
    mask[1, 100:] = False
    strips = t_sm.pack_labels((torch.rand((2, 128), generator=gen) < 0.3).float(), mask)
    scalars = torch.tensor([[1.07, 0.5, 0.5, 0.0]] * 2)
    fp = _check.pad_channels(f)
    for a, b in zip(t_sm.sm_loss_sums_plain(fp, strips, scalars),
                    t_sm.sm_loss_sums_plain(f, strips, scalars)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    (df_p, ds_p), (df, ds) = (t_sm.sm_loss_grads_plain(x, strips, scalars) for x in (fp, f))
    _close_and_zero_padded(df_p, df)
    torch.testing.assert_close(ds_p, ds, atol=1e-6, rtol=0)
    seeds = torch.stack([torch.randperm(128, generator=gen)[:12] for _ in range(2)])
    bias = t_knn.knn_bias(mask, f)
    assert torch.equal(t_knn.seed_knn_plain(fp, seeds, 16, bias),
                       t_knn.seed_knn_plain(f, seeds, 16, bias))
