"""The symmetric int8 cache (``csrc/compat_cache_sym.cu``) on the CPU: its
work plan against the triangle it must cover, the production wrapper's
route between the two cache kernels, and the plain versions against JAX's
``build_compat_cache_int8`` in interpret mode at a ragged N.

The plan is modelled on a grid of 32 x 32 cells, as the kernel writes it:
an item (strip, first band, bands) writes each of its bands' 32 rows across
the strip's 512 columns, and a band left of the strip's diagonal block also
writes its transpose (the strip's rows, the band's columns)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdsc_tpu.kernels import sc_attention as j_att
from pointdsc_tpu_torch.kernels import sc_attention as t_att
from pointdsc_tpu_torch.kernels import symcache as t_sym

CELL = t_att.SYM_BAND
STRIP_CELLS = t_att.SYM_COLS // CELL


def plan_writes(plan, n):
    """(direct, mirror): how often the plan writes each 32 x 32 cell of the
    [n, n] cache straight from the computation and by the mirror."""
    cells = -(-n // CELL)
    direct = np.zeros((cells, cells), np.int32)
    mirror = np.zeros((cells, cells), np.int32)
    for strip, first, count in plan:
        c0, c1 = STRIP_CELLS * strip, min(STRIP_CELLS * (strip + 1), cells)
        for band in range(first, first + count):
            direct[band, c0:c1] += 1
            if band < c0:
                mirror[c0:c1, band] += 1
    return direct, mirror


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("n", [1, 511, 512, 513, 5000, 5120, 12288, 20480])
def test_plan_covers_the_triangle(n, batch):
    """Every upper entry (the diagonal's included) is computed and written
    once; every strictly lower entry is written once, by a mirror write or in
    its diagonal block, never both; the items fit one wave of the H100's
    resident blocks, the most work first, and hold as little work as that
    allows (a band of a diagonal block counted at its measured cost)."""
    sms = 132
    plan = t_att.symmetric_cache_plan(batch, n, sms)
    direct, mirror = plan_writes(plan, n)
    cells = direct.shape[0]
    i, j = np.indices((cells, cells))
    assert (direct + mirror == 1).all()
    assert (direct[i <= j] == 1).all()
    assert (mirror[i // STRIP_CELLS <= j // STRIP_CELLS] == 0).all()
    slots = max(1, t_att.SYM_BLOCKS_PER_SM * sms // batch)
    costs = t_att.symmetric_band_costs(n)
    work = [sum(costs[s][first:first + count]) for s, first, count in plan]
    assert len(plan) <= slots and min(count for _, _, count in plan) >= 1
    assert work == sorted(work, reverse=True)
    limit = max(work)
    assert limit == max(map(max, costs)) or \
        sum(len(t_att._cut(c, limit - 1)) for c in costs) > slots
    assert [len(c) for c in costs] == \
        [-(-min(t_att.SYM_COLS * (s + 1), n) // CELL) for s in range(-(-n // t_att.SYM_COLS))]


@pytest.mark.parametrize("sms,items", [(16, 16), (8, 10)])
def test_plan_on_small_cards(sms, items):
    """On a card with few SMs the items are longer; with fewer resident
    blocks than strips (N = 5000: 10 strips) each strip is one item."""
    plan = t_att.symmetric_cache_plan(2, 5000, sms)
    direct, mirror = plan_writes(plan, 5000)
    assert (direct + mirror == 1).all() and len(plan) == items


@pytest.mark.parametrize("n", [1000, 2048, 3071, 3072, 5000, 5120, 12288, 20480])
def test_route_follows_the_gate(n, monkeypatch):
    """On the card the production wrapper launches the symmetric kernel where
    ``use_symmetric_cache`` says so and the full-grid one elsewhere, one
    launch and one count a build either way (spies stand for the launches)."""
    calls = []

    def spy(name):
        def launch(src, tgt, coef):
            calls.append((name, src.dtype, coef))
            return torch.zeros((src.shape[0], src.shape[1], src.shape[1]), dtype=torch.int8)
        return launch

    monkeypatch.setattr(t_att, "on_cuda", lambda t: True)
    monkeypatch.setattr(t_att, "_launch_compat_cache", spy("full_grid"))
    monkeypatch.setattr(t_att, "_launch_compat_cache_sym", spy("symmetric"))
    monkeypatch.setattr(t_att.build_compat_cache_int8, "launches", 0)
    pts = torch.zeros((1, n, 3), dtype=torch.float64)
    t_att.build_compat_cache_int8(pts, pts, 0.1)
    want = "symmetric" if t_att.use_symmetric_cache(n) else "full_grid"
    assert calls == [(want, torch.float32, t_att.cache_coef(0.1))]
    assert t_att.build_compat_cache_int8.launches == 1


def test_gate_decisions():
    """The crossover measured on the card (PERF.md, row 15): the symmetric
    kernel from SYM_MIN_N on, at every standard size."""
    assert [t_att.use_symmetric_cache(n) for n in (1000, t_att.SYM_MIN_N - 1, t_att.SYM_MIN_N,
                                                   5000, 5120, 12288, 20480)] == \
        [False, False, True, True, True, True, True]


@pytest.mark.parametrize("n", [300, 500])
def test_plain_versions_against_jax(rng, n):
    """At a ragged N (not a multiple of 16; JAX builds N <= 512 as one
    full-grid tile, in interpret mode) the symmetric wrapper's and the production wrapper's CPU results
    against JAX's: +-1 on at most 0.1% of entries (both round 127 * compat;
    an entry within an ulp of a .5 boundary may round either way); the
    symmetric one exactly symmetric, and equal to the production one's upper
    triangle."""
    src = rng.uniform(-1.5, 1.5, size=(2, n, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    tgt = (src @ q.T + rng.normal(scale=0.01, size=src.shape)).astype(np.float32)
    tgt[:, n // 2:] = rng.uniform(-1.5, 1.5, size=(2, n - n // 2, 3))
    src[:, 7] = src[:, 3]  # a repeated point: a zero distance off the diagonal
    mask = np.arange(n)[None].repeat(2, 0) < n - n // 20
    ref = np.asarray(j_att.build_compat_cache_int8(
        jnp.asarray(src), jnp.asarray(tgt), 0.1, mask=jnp.asarray(mask),
        interpret=True)).astype(np.int32)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), 0.1)
    sym = t_sym.build_compat_cache_int8_sym(*args, mask=torch.from_numpy(mask)).numpy()
    prod = t_att.build_compat_cache_int8(*args, mask=torch.from_numpy(mask)).numpy()
    assert (sym == sym.transpose(0, 2, 1)).all()
    iu = np.triu_indices(n)
    assert (sym[:, iu[0], iu[1]] == prod[:, iu[0], iu[1]]).all()
    for out in (sym, prod):
        diff = np.abs(out.astype(np.int32) - ref)
        assert diff.max() <= 1
        assert (diff == 1).mean() <= 1e-3
