"""The running-max cached attention on the operands the JAX wrapper gives its
kernel off the CPU: ``fused_sc_attention_cached`` (``use_bf16=True``) rounds
q, k, v to bf16, and the kernel rounds p to its v's type before p v. The
port's plain version on bf16 q, k, v is held to JAX's kernel in interpret
mode fed the same bf16 values; its f32 form is the function the port ran on
the card before, and lies further from it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu_torch.kernels import sc_attention as t_att

C = 128


def inputs(rng, n, masked):
    """Unit-normal q, k, v [n, C], an int8 cache of random compat values and
    the geometry strip (row 8 the key bias: the last ``masked`` keys -1e9)."""
    q, k, v = (rng.normal(size=(n, C)).astype(np.float32) for _ in range(3))
    compat = rng.integers(0, 128, size=(n, n)).astype(np.int8)
    geom = np.zeros((16, n), np.float32)
    if masked:
        geom[8, n - masked:] = -1e9
    return q, k, v, compat, geom


# (n, masked keys, block): 128-row key tiles, and at n = 1000 five tiles of
# 200 rows (the kernel's grid needs a block that divides n)
CASES = [(256, 0, 128), (1000, 200, 200)]


@pytest.mark.parametrize("n,masked,block", CASES)
def test_plain_on_bf16_operands_matches_jax_kernel_fed_bf16(rng, n, masked, block):
    """atol = rtol = 2e-3: both sum exact products of the same bf16 values
    in f32 and round p to bf16, JAX per key tile against its running max
    and the plain version once against the row's maximum, so a p on a
    bf16 rounding boundary may round either way (one of n terms moved by
    2^-9 relative). The mean error of the bf16 form is below the f32 form's,
    which skips both roundings."""
    q, k, v, compat, geom = inputs(rng, n, masked)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(j_att._fused_sc_attention_cached_single(
        qb, kb, vb, jnp.asarray(compat), jnp.asarray(geom), block_q=block, block_k=block,
        interpret=True, offset_softmax=False))

    bias = torch.from_numpy(geom[8].copy())[None]
    ct = torch.from_numpy(compat)[None]
    qt, kt, vt = (torch.from_numpy(x)[None] for x in (q, k, v))
    out_bf16 = t_att.sc_attention_cached_plain(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                                               ct, bias)[0].numpy()
    out_f32 = t_att.sc_attention_cached_plain(qt, kt, vt, ct, bias)[0].numpy()
    assert out_bf16.dtype == np.float32
    np.testing.assert_allclose(out_bf16, ref, atol=2e-3, rtol=2e-3)
    err_bf16, err_f32 = np.abs(out_bf16 - ref), np.abs(out_f32 - ref)
    print(f"n={n}: max |err| bf16 {err_bf16.max():.3e} f32 {err_f32.max():.3e}; "
          f"mean bf16 {err_bf16.mean():.3e} f32 {err_f32.mean():.3e}")
    assert err_bf16.mean() < err_f32.mean()


# The no-cache attention (JAX's _sc_attention_kernel): the same wrapper cast
# (fused_sc_attention, use_bf16=True), p rounded to v's type, the compat tile
# computed from the packed geometry.

SIGMA_D = 0.1


def geometry(rng, n, masked):
    """pack_geometry's strip [16, n] of a pair of half inliers under a rigid
    motion and half outliers, the last ``masked`` points padded."""
    src = rng.uniform(-1.5, 1.5, size=(1, n, 3)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    tgt = (src @ rot.T + rng.normal(scale=0.01, size=src.shape)).astype(np.float32)
    out = rng.uniform(size=n) < 0.5
    tgt[0, out] = rng.uniform(-1.5, 1.5, size=(int(out.sum()), 3))
    mask = torch.from_numpy(np.arange(n) < n - masked)[None]
    return t_att.pack_geometry(torch.from_numpy(src), torch.from_numpy(tgt), mask)


@pytest.mark.parametrize("n,masked,block", [(256, 32, 128), (1000, 200, 200)])
def test_nocache_plain_on_bf16_operands_matches_jax_kernel_fed_bf16(rng, n, masked, block):
    """The no-cache plain version on bf16 q, k, v against JAX's
    ``_fused_sc_attention_single`` in interpret mode fed the same bf16 values
    and the same geometry strip, atol = rtol = 2e-3: both sum exact products
    of the bf16 values in f32 and round p to bf16, JAX per key tile against
    its running max and the plain version once against the row's maximum,
    and their compat tiles differ in the last bits (JAX's inner products are
    dot_generals, the plain version's are written out); a p on a bf16
    rounding boundary may round either way (one of n terms moved by 2^-9
    relative). The mean error of the bf16 form is below the f32 form's,
    which skips both roundings."""
    q, k, v = (rng.normal(size=(n, C)).astype(np.float32) for _ in range(3))
    geom = geometry(rng, n, masked)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(j_att._fused_sc_attention_single(
        qb, kb, vb, jnp.asarray(geom[0].numpy()), SIGMA_D, block_q=block, block_k=block,
        interpret=True))

    qt, kt, vt = (torch.from_numpy(x)[None] for x in (q, k, v))
    out_bf16 = t_att.sc_attention_nocache_plain(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                                                geom, SIGMA_D)[0].numpy()
    out_f32 = t_att.sc_attention_nocache_plain(qt, kt, vt, geom, SIGMA_D)[0].numpy()
    assert out_bf16.dtype == np.float32
    np.testing.assert_allclose(out_bf16, ref, atol=2e-3, rtol=2e-3)
    err_bf16, err_f32 = np.abs(out_bf16 - ref), np.abs(out_f32 - ref)
    print(f"n={n}: max |err| bf16 {err_bf16.max():.3e} f32 {err_f32.max():.3e}; "
          f"mean bf16 {err_bf16.mean():.3e} f32 {err_f32.mean():.3e}")
    assert err_bf16.mean() < err_f32.mean()


def test_nocache_plain_on_f32_is_the_trainable_forward(rng):
    """On f32 operands (the CPU's, as JAX's interpret mode leaves them) the
    no-cache plain version is the trainable forward's out, bit for bit."""
    n = 256
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, C)).astype(np.float32))
               for _ in range(3))
    geom = geometry(rng, n, 32)
    out = t_att.sc_attention_nocache_plain(q, k, v, geom, SIGMA_D)
    assert torch.equal(out, t_att.sc_attention_forward_plain(q, k, v, geom, SIGMA_D)[0])
