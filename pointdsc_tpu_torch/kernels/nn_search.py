"""Exact 3-D nearest neighbour (PyTorch wrapper of ``csrc/nn_search.cu``;
counterpart of ``pointdsc_tpu/kernels/nn_search.py``).

For every query point, the squared distance and index of its nearest base
point, d2 = (|q|^2 + |b|^2) - 2 q.b in float32 and not clamped, as the TPU
kernel computes it. Masked base points carry |b|^2 = 1e30 and never win; ties
go to the lowest base index; a query whose base points are all masked gets
index 0 and d2 = 1e30. The kernel reads the clouds and the mask in place and
streams base tiles through shared memory, so nothing [N, M] exists and a
search is one launch: one device operation, or two where the base is split
over blocks (the merge's workspace set to ones, then the kernel). On a CPU
tensor the wrapper runs its plain version, which forms the [N, M] matrix.
"""

from __future__ import annotations

import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda

_BIG = 1e30
MAX_BASE = 1 << 24  # the TPU kernel carries the index in f32: exact below 2^24

# the kernel's grid (csrc/nn_search.cu): 128 threads of 4 query rows a block
# (the C entry refuses a launch whose query blocks differ), at most 8 blocks an
# SM (its launch bounds; here only to size the splits); a base range at least
# MIN_RANGE points
ROWS_PER_BLOCK = 512
BLOCKS_PER_SM = 8
MIN_RANGE = 32

# The work of one search, counted from csrc/nn_search.cu. Operations of the
# bound: 9 f32 operations a (query, base) pair (the 3-dot 5, the norm sum 1,
# 2x and the subtraction 2, the compare 1) and 5 for each point's norm, at the
# f32 rate. Instructions of the issue floor: 10 a pair (3 FMUL, 3 FADD, one
# FFMA, the compare and two selects), each one lane-slot of an SM's 128 a
# clock: the f32 rate counts an FMA as two operations, and the kernel may not
# contract its products and sums (d2 is bit for bit the plain version's).
OPS_PER_PAIR = 9
OPS_PER_POINT = 5
INSTRUCTIONS_PER_PAIR = 10
# published H100 SXM figures: 132 SMs, 1980 MHz maximum SM clock, 128 f32
# lanes an SM
H100_SMS, H100_MAX_SM_CLOCK_HZ, LANES_PER_SM = 132, 1.98e9, 128


def nn_search_work(batch: int, n: int, m: int, masked: bool = False) -> tuple[float, float]:
    """(bytes, operations) of one search: the clouds' xyz and the mask read
    once, d2 (f32) and the index (int64) written once; OPS_PER_PAIR for each
    of the batch n m pairs and OPS_PER_POINT for each point."""
    bytes_moved = batch * ((n + m) * 12 + (m if masked else 0) + n * (4 + 8))
    return float(bytes_moved), float(batch) * (n * m * OPS_PER_PAIR + (n + m) * OPS_PER_POINT)


def nn_issue_floor_ms(batch: int, n: int, m: int, sms: int = H100_SMS,
                      clock_hz: float = H100_MAX_SM_CLOCK_HZ) -> float:
    """The least time the kernel's pair instructions can issue in:
    INSTRUCTIONS_PER_PAIR for each pair at LANES_PER_SM lanes a clock on
    every SM."""
    return float(batch) * n * m * INSTRUCTIONS_PER_PAIR / (sms * LANES_PER_SM * clock_hz) * 1e3


def nn_grid(batch: int, n: int, m: int, sms: int) -> tuple[int, int, int]:
    """(query blocks, splits, range) of a launch: blocks of ROWS_PER_BLOCK
    query rows, the base cut into ``splits`` consecutive ranges of ``range``
    points (a multiple of 4) covering it. Splits fill one wave of
    BLOCKS_PER_SM blocks on each of ``sms`` SMs where the query blocks alone
    do not, with ranges of at least MIN_RANGE points."""
    qblocks = -(-n // ROWS_PER_BLOCK)
    splits = max(1, min(sms * BLOCKS_PER_SM // max(1, qblocks * batch), m // MIN_RANGE))
    rng = max(4, (-(-m // splits) + 3) // 4 * 4)
    return qblocks, max(1, -(-m // rng)), rng


def pack_points(pts: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """[..., N, 4] f32: x, y, z, |p|^2 = (x x + y y) + z z, the kernel's
    sum written out (1e30 where ``mask`` is False)."""
    pts = pts.float()
    x, y, z = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
    sq = (x * x + y * y) + z * z
    if mask is not None:
        sq = torch.where(mask[..., None], sq, torch.full_like(sq, _BIG))
    return torch.cat([pts, sq], dim=-1).contiguous()


def nearest_neighbors_plain(qp: torch.Tensor, bp: torch.Tensor):
    """Plain version on packed [B, N, 4] / [B, M, 4]: the [B, N, M] matrix
    with the kernel's operations in its order (the 3-term dot product written
    out elementwise, so nothing is contracted), then the first minimum; a row
    with nothing below 1e30 gets (1e30, 0), as the kernel's running minimum."""
    inner = (qp[..., :, None, 0] * bp[..., None, :, 0] + qp[..., :, None, 1] * bp[..., None, :, 1]) \
        + qp[..., :, None, 2] * bp[..., None, :, 2]
    d2 = (qp[..., :, None, 3] + bp[..., None, :, 3]) - 2.0 * inner
    dmin, idx = torch.min(d2, dim=-1)
    found = dmin < _BIG
    return (torch.where(found, dmin, torch.full_like(dmin, _BIG)),
            torch.where(found, idx, torch.zeros_like(idx)))


def _launch_nn(query, base, mask):
    """query [B, N, 3], base [B, M, 3] f32 and mask [B, M] bool or None,
    contiguous, on one card -> (d2 [B, N] f32, idx [B, N] int64)."""
    b, n, _ = query.shape
    m = base.shape[1]
    dev = query.device
    d2 = torch.empty((b, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int64, device=dev)
    if b * n == 0:
        return d2, idx
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    qblocks, splits, rng = nn_grid(b, n, m, sms)
    work = None
    if splits > 1:  # the merge's b n keys, then b qblocks 4-byte counters; the entry sets them
        work = torch.empty((b * n + -(-b * qblocks // 2),), dtype=torch.int64, device=dev)
    nearest_neighbors.launches += 1
    _build.launch("nn_search", "nearest_neighbors", dev, query.data_ptr(), base.data_ptr(),
                  0 if mask is None else mask.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                  0 if work is None else work.data_ptr(), b, n, m, qblocks, splits, rng,
                  0 if work is None else work.numel())
    return d2, idx


def nearest_neighbors(query: torch.Tensor, base: torch.Tensor,
                      base_mask: torch.Tensor | None = None):
    """(d2 [..., N] f32, idx [..., N] int64) of each query point's nearest
    base point. query [N, 3] or [B, N, 3], base [M, 3] or [B, M, 3],
    base_mask [M] / [B, M] bool or None (masked points are never chosen).
    A batch runs in one launch. Refuses M >= 2^24, as the TPU kernel does."""
    if base.shape[-2] >= MAX_BASE:
        raise ValueError(
            f"nearest_neighbors: base cloud has {base.shape[-2]} points; the kernel's "
            "index is exact only below 2^24 (the TPU kernel's f32 carry). Split the base cloud.")
    expect(query, "query", dtype=torch.float32, last=3)
    expect(base, "base", dtype=torch.float32, ndim=query.ndim, last=3, device=query.device)
    if query.ndim not in (2, 3) or query.shape[:-2] != base.shape[:-2]:
        raise ValueError(f"query {tuple(query.shape)} and base {tuple(base.shape)}: expected "
                         "[N, 3] and [M, 3], or [B, N, 3] and [B, M, 3]")
    if base_mask is not None:
        expect(base_mask, "base_mask", dtype=torch.bool, shape=base.shape[:-1],
               device=query.device)
    single = query.ndim == 2
    if single:
        query, base = query[None], base[None]
        base_mask = None if base_mask is None else base_mask[None]
    if not on_cuda(query):
        d2, idx = nearest_neighbors_plain(pack_points(query), pack_points(base, base_mask))
    else:
        d2, idx = _launch_nn(query.contiguous(), base.contiguous(),
                             None if base_mask is None else base_mask.contiguous())
    return (d2[0], idx[0]) if single else (d2, idx)


nearest_neighbors.launches = 0
