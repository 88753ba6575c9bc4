"""The nearest-neighbour kernel's launch plan and merge rule, on the CPU: the
grid's base ranges (``kernels/nn_search.py::nn_grid``), the bound and issue
floor that ``chip_smoke.py`` and ``tools/time_attention.py`` read, and a
numpy model of the kernel's split search (each range's strictly-below-1e30
first minimum, then the least 64-bit key of order-preserving d2 bits and
index over the ranges) against the plain version. The kernel itself is held
to the plain version on the card (``tests/test_torch_port_cuda.py``)."""

import numpy as np
import pytest
import torch

from pointdsc_tpu_torch.kernels import nn_search as t_nn
from pointdsc_tpu_torch.tools import time_attention

SMS = 132  # the H100 SXM's


def test_nn_search_bound_and_issue_floor():
    """At N = M = 20480: 9 f32 operations a pair at 67 TFLOP/s bound it at
    0.05634 ms (the bytes take a few thousandths of that); 10 instructions a
    pair at 128 lanes a clock on 132 SMs at 1980 MHz take 0.12537 ms."""
    bound, by = time_attention.bound_ms(*t_nn.nn_search_work(1, 20480, 20480))
    assert by == "operations" and abs(bound - 0.0563444537) < 1e-9, (bound, by)
    assert abs(t_nn.nn_issue_floor_ms(1, 20480, 20480) - 0.1253749617) < 1e-9
    assert t_nn.nn_issue_floor_ms(2, 100, 300) == 2 * t_nn.nn_issue_floor_ms(1, 300, 100)


@pytest.mark.parametrize("batch,n,m", [(1, 2048, 2048), (1, 5120, 5120), (1, 20480, 20480),
                                       (2, 65, 3000), (1, 64, 20480), (1, 2048, 40),
                                       (4, 600000, 100), (1, 10, 0), (1, 3, 5)])
def test_nn_grid(batch, n, m):
    """Query blocks cover N; the ranges, multiples of 4, cover M with none
    empty; a split base has ranges of at least MIN_RANGE points and its grid
    fits one wave of BLOCKS_PER_SM blocks an SM; at N = M = 2048 the grid
    has a block for every SM."""
    qblocks, splits, rng = t_nn.nn_grid(batch, n, m, SMS)
    assert (qblocks - 1) * t_nn.ROWS_PER_BLOCK < n <= qblocks * t_nn.ROWS_PER_BLOCK
    assert rng % 4 == 0 and splits * rng >= m and (splits - 1) * rng < max(m, 1)
    if splits > 1:
        assert rng >= t_nn.MIN_RANGE
        assert qblocks * splits * batch <= SMS * t_nn.BLOCKS_PER_SM
    if (n, m) == (2048, 2048):
        assert qblocks * splits >= SMS


def ordered_bits(d):
    """The kernel's order-preserving bits of float32 d, as uint64."""
    u = d.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def split_search(d2, rng):
    """The kernel's result from the [N, M] d2 matrix with the base cut into
    ranges of ``rng`` points: each range's first minimum if below 1e30, then
    the least (d2 bits, index) key over the ranges; (1e30, 0) without one."""
    none = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys = np.full(d2.shape[0], none, dtype=np.uint64)
    for r0 in range(0, d2.shape[1], rng):
        part = d2[:, r0:r0 + rng]
        dmin, arg = part.min(axis=1), part.argmin(axis=1)
        key = (ordered_bits(dmin) << np.uint64(32)) | (arg + r0).astype(np.uint64)
        keys = np.where(dmin < np.float32(1e30), np.minimum(keys, key), keys)
    found = keys != none
    bits = (keys >> np.uint64(32)).astype(np.uint32)
    back = np.where(bits & 0x80000000, bits & 0x7FFFFFFF, ~bits).astype(np.uint32)
    return (np.where(found, back.view(np.float32), np.float32(1e30)),
            np.where(found, keys & np.uint64(0xFFFFFFFF), 0).astype(np.int64))


@pytest.mark.parametrize("case", ["random", "negative_d2", "ties_across_ranges", "masked",
                                  "all_masked"])
def test_split_merge_is_the_plain_rule(rng, case):
    """The model of the split search equals the plain version bit for bit
    (d2 and index) on N = 64 queries against M = 4096 base points cut as the
    grid cuts them (ranges of 32): random points; points ~100 m out with
    queries within 1e-5 of base points (negative d2 from rounding); copies of
    each query's point on both sides of a range boundary; 30% and all of the
    base masked."""
    n, m = 64, 4096
    _, splits, width = t_nn.nn_grid(1, n, m, SMS)
    assert splits > n and width == 32
    base = rng.uniform(0.0, 3.0, size=(m, 3)).astype(np.float32)
    query = rng.uniform(0.0, 3.0, size=(n, 3)).astype(np.float32)
    mask = None
    if case == "negative_d2":
        base += 100.0
        query = base[rng.choice(m, n, replace=False)] + rng.normal(scale=1e-5, size=(n, 3))
    elif case == "ties_across_ranges":
        for i in range(n):
            base[[(i + 1) * width - 1, (i + 1) * width]] = query[i]
    elif case != "random":
        mask = rng.uniform(size=m) >= (0.3 if case == "masked" else 1.1)
    qp = t_nn.pack_points(torch.from_numpy(query.astype(np.float32)))[None]
    bp = t_nn.pack_points(torch.from_numpy(base),
                          None if mask is None else torch.from_numpy(mask))[None]
    pd, pi = (t.numpy()[0] for t in t_nn.nearest_neighbors_plain(qp, bp))
    q, b = qp[0].numpy(), bp[0].numpy()
    inner = (q[:, None, 0] * b[None, :, 0] + q[:, None, 1] * b[None, :, 1]) \
        + q[:, None, 2] * b[None, :, 2]
    d2 = (q[:, None, 3] + b[None, :, 3]) - np.float32(2.0) * inner
    sd, si = split_search(d2, width)
    assert np.array_equal(sd.view(np.uint32), pd.view(np.uint32)) and np.array_equal(si, pi)
    if case == "negative_d2":
        assert (sd < 0).any()
    if case == "ties_across_ranges":
        assert np.array_equal(si, (np.arange(n) + 1) * width - 1)
    if case == "all_masked":
        assert (si == 0).all() and (sd == np.float32(1e30)).all()
