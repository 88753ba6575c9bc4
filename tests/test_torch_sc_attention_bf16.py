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
