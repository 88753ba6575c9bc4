"""The work plan of the running-max cached attention kernel at C = 128
(``kernels/sc_attention.py::cached_attention_plan``), on the CPU: every
(query tile, key tile) of every sample once, one wave of blocks with equal
runs on the H100's 132 SMs, and the merge rule of split query tiles (an
emulation of the kernel's per-item running max and its merge) against the
plain version, a wholly masked split at weight exactly 0."""

import itertools

import numpy as np
import pytest
import torch

from pointdsc_tpu_torch.kernels import sc_attention as katt

SMS = 132  # the H100 SXM's


def check_plan(plan, batch, n, sms):
    tiles = -(-n // katt.ATTN_ROWS)
    keys = -(-n // katt.ATTN_KEYS)
    blocks = len(plan.first) - 1
    assert blocks == min(sms, batch * tiles * keys)
    assert plan.first[0] == 0 and plan.first[-1] == len(plan.items)
    assert all(a < b for a, b in zip(plan.first, plan.first[1:]))  # no block idles
    seen = np.zeros((batch, tiles, keys), dtype=np.int64)
    for b, qt, k0, count, _ in plan.items:
        assert 0 <= b < batch and 0 <= qt < tiles and count > 0 and 0 <= k0 < k0 + count <= keys
        seen[b, qt, k0:k0 + count] += 1
    assert (seen == 1).all()
    # a query tile walked by more than one item is a merge of its items' slots
    walkers = {}
    for i, item in enumerate(plan.items):
        walkers.setdefault(item[:2], []).append(i)
    merges = {m[:2]: m for m in plan.merges}
    for tile, idx in walkers.items():
        slots = [plan.items[i][4] for i in idx]
        if len(idx) == 1:
            assert slots == [-1] and tile not in merges
        else:
            _, _, first, count = merges[tile]
            assert idx == list(range(idx[0], idx[0] + len(idx)))
            assert slots == list(range(first, first + count)) and count == len(idx)
    assert plan.splits == len(plan.merges) == len(merges)
    assert plan.slots == sum(m[3] for m in plan.merges)
    return [sum(plan.items[i][3] for i in range(plan.first[j], plan.first[j + 1]))
            for j in range(blocks)]


@pytest.mark.parametrize("batch,n", [(1, 1), (1, 100), (3, 100), (2, 1000), (16, 1024),
                                     (1, 5120), (2, 12289), (1, 12288), (1, 20480),
                                     (200, 128)])
def test_plan_covers_every_tile_once(batch, n):
    check_plan(katt.cached_attention_plan(batch, n, SMS), batch, n, SMS)


@pytest.mark.parametrize("n", [5120, 12288, 20480])
def test_plan_fills_one_wave(n):
    """132 blocks, one an SM, whose runs differ by at most one key tile."""
    work = check_plan(katt.cached_attention_plan(1, n, SMS), 1, n, SMS)
    assert len(work) == SMS and max(work) - min(work) <= 1


def split_attention(q, k, v, compat, bias, plan):
    """The kernel's arithmetic on the CPU in float64 (but p rounded to bf16
    before p v): each item's running max over its key tiles in log2 units
    from m = -1e9 log2 e, whole items divided by l + 1e-30, split ones
    merged with weights 2^(m_s - m)."""
    q, k, v = q.double(), k.double(), v.double()
    batch, n, _ = q.shape
    log2e = 1.0 / np.log(2.0)
    scale = katt.qk_scale(q.shape[-1]) * log2e
    out = torch.zeros_like(q)
    parts = {}
    for b, qt, k0, count, slot in plan.items:
        rows = slice(qt * katt.ATTN_ROWS, min((qt + 1) * katt.ATTN_ROWS, n))
        m = torch.full((rows.stop - rows.start, 1), -1e9 * log2e, dtype=torch.float64)
        l = torch.zeros_like(m)
        acc = torch.zeros((m.shape[0], q.shape[-1]), dtype=torch.float64)
        for t in range(k0, k0 + count):
            cols = slice(t * katt.ATTN_KEYS, min((t + 1) * katt.ATTN_KEYS, n))
            s = (compat[b, rows, cols].double() * (q[b, rows] @ k[b, cols].T * scale)
                 + bias[b, cols].double() * log2e)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).double() @ v[b, cols]
            m = m_new
        if slot < 0:
            out[b, rows] = acc / (l + 1e-30)
        else:
            parts[slot] = (m, l, acc)
    for b, qt, first, count in plan.merges:
        rows = slice(qt * katt.ATTN_ROWS, min((qt + 1) * katt.ATTN_ROWS, n))
        ms, ls, accs = zip(*(parts[s] for s in range(first, first + count)))
        m = torch.stack(ms).amax(0)
        w = [torch.exp2(ms_ - m) for ms_ in ms]
        l = sum(wi * li for wi, li in zip(w, ls))
        out[b, rows] = sum(wi * ai for wi, ai in zip(w, accs)) / (l + 1e-30)
    return out


@pytest.mark.parametrize("sms", [7, 20])
def test_split_merge_matches_plain(sms):
    """At N = 700 (ragged) on a plan of 7 or 20 blocks, query tiles split,
    the second sample's keys from a whole split on masked: the emulation is the plain version's within the card tests'
    2e-3, and v = 1e6 on the masked keys changes it by nothing."""
    batch, n = 2, 700
    plan = katt.cached_attention_plan(batch, n, sms)
    keys = -(-n // katt.ATTN_KEYS)
    tails = [it for it in plan.items if it[0] == 1 and it[4] >= 0 and it[2] > 0
             and it[2] + it[3] == keys]
    assert plan.splits > 0 and tails
    first_masked = max(it[2] for it in tails) * katt.ATTN_KEYS
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((batch, n, 128), generator=gen).bfloat16() for _ in range(3))
    compat = torch.randint(0, 128, (batch, n, n), generator=gen, dtype=torch.int8)
    mask = torch.ones((batch, n), dtype=torch.bool)
    mask[1, first_masked:] = False
    bias = katt.key_bias(mask, batch, n, q.device)
    out = split_attention(q, k, v, compat, bias, plan)
    ref = katt.sc_attention_cached_plain(q, k, v, compat, bias)
    torch.testing.assert_close(out.float(), ref, atol=2e-3, rtol=2e-3)
    v2 = v.clone()
    v2[1, first_masked:] = 1e6
    assert torch.equal(split_attention(q, k, v2, compat, bias, plan), out)


def test_plans_are_whole_for_each_sm_count():
    """The plan's invariants hold for any SM count, not only the H100's."""
    sizes = ((1, 300), (4, 513), (3, 1))
    for sms, (batch, n) in itertools.product((1, 2, 31, 114, 132, 264), sizes):
        check_plan(katt.cached_attention_plan(batch, n, sms), batch, n, sms)
