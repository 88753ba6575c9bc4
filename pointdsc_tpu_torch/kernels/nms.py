"""Seed NMS from coordinates (PyTorch wrappers of ``csrc/nms.cu``;
counterpart of ``pointdsc_tpu/kernels/nms.py:26-214``).

    is_local_max[i] = all_j ( score[i] >= score[j]  or  d2(i, j) >= R^2 )

The seeds are the top S of score * flag by IEEE total order, ties to the
lower index, as ``jax.lax.top_k`` orders them (ops/nms.py::top_k_like_jax).
On the card three kernels pick them without an [N, N] matrix or a sort:
``nms_local_max`` (the flags and the seed keys, read from src, scores and
mask in place), ``nms_select`` (an exact radix select of the S largest keys)
and, for the large-N prefilter, ``nms_top_m`` (the select of the top-M
scores). The select sorts up to ``SHARED_SELECT`` seeds in shared memory and
any more in a workspace in device memory (``select_workspace_size``): any S.
The prefilter's two decisions, JAX's ``lax.cond`` on the device, are device
flags that gate the later launches: no host sync. On a CPU tensor
each wrapper runs its plain version, a gate read on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch.kernels import _build
from pointdsc_tpu_torch.kernels._check import expect, on_cuda
from pointdsc_tpu_torch.ops.nms import _total_order_key, nms_key, top_k_like_jax

_NEG = -1e9
SHARED_SELECT = 8192  # the largest k the seed select sorts in shared memory (csrc/nms.cu)
FLAG_WARPS = 16  # warps of a flags block, each a slice of the keys (csrc/nms.cu KWARPS)


def radius_sq(radius: float) -> float:
    """R^2 evaluated in float32, as the TPU kernel does."""
    r = np.float32(radius)
    return float(r * r)


def nms_local_max_plain(src: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor | None,
                        r2: float, chunk: int = 2048) -> torch.Tensor:
    """Plain version of the flag kernel: scores at -1e9 where invalid (they
    never suppress), the squared norms (x x + y y) + z z and the gram-form
    d2 (|x|^2 + |x'|^2) - 2 ((x x' + y y') + z z'), every product and sum
    rounded on its own in the kernel's order; AND over keys; queries in
    chunks."""
    x, y, z = src.float().unbind(-1)
    s = scores.float()
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    sq = x * x + y * y + z * z
    r2t = torch.tensor(r2, dtype=torch.float32, device=src.device)
    flags = []
    for lo in range(0, src.shape[1], chunk):
        q = slice(lo, lo + chunk)
        inner = (x[:, q, None] * x[:, None] + y[:, q, None] * y[:, None]
                 + z[:, q, None] * z[:, None])
        d2 = torch.clamp(sq[:, q, None] + sq[:, None] - 2.0 * inner, min=0.0)
        flags.append(torch.all((s[:, q, None] >= s[:, None]) | (d2 >= r2t), dim=-1))
    return torch.cat(flags, dim=1).float()


def _gate_open(gate) -> bool:
    """The plain version of a launch's gate (flags [B], want), on the host."""
    flags, want = gate
    return bool(torch.all(flags != 0)) == bool(want)


def _gate_args(gate, b, device):
    if gate is None:
        return None, 0
    flags, want = gate
    expect(flags, "gate", dtype=torch.int32, shape=(b,), device=device)
    return flags.data_ptr(), int(want)


def _launch_flags(src, scores, mask, subset, gate, r2, keys, out=None, tiles=None):
    """The flags [B, K] f32, or with ``keys`` the seed keys [B, K] int32,
    into ``out`` (a new tensor when None)."""
    b, n_all = scores.shape
    k = n_all if subset is None else subset.shape[1]
    if out is None:
        out = torch.empty((b, k), dtype=torch.int32 if keys else torch.float32, device=src.device)
    gate_ptr, want = _gate_args(gate, b, src.device)
    _build.launch("nms", "nms_local_max", src.device, src.data_ptr(), scores.data_ptr(),
                  None if mask is None else mask.data_ptr(),
                  None if subset is None else subset.data_ptr(), gate_ptr, want, b, n_all, k,
                  r2, None if keys else out.data_ptr(), out.data_ptr() if keys else None,
                  None if tiles is None else tiles.data_ptr())
    return out


def nms_local_max(src, scores, radius, mask=None, subset=None, gate=None, keys=False, out=None):
    """Local-max flags [B, K] (f32 in {0, 1}) from src [B, N, 3] and scores
    [B, N]: over all N points (K = N), or over the K points of ``subset``
    [B, K] (int32 indices into [0, N), as ``nms_top_m`` writes them; the
    kernel reads point 0 for one outside), each against the others of the
    subset.

    ``keys``: the seed keys [B, K] instead, int32 total-order keys
    (ops/nms.py::_total_order_key) of score * flag, -inf for an invalid
    point. ``gate`` (flags [B] int32, want): the kernel computes only if the
    AND of the gate's flags equals ``want``; otherwise the output is left
    unwritten. ``out``: the [B, K] tensor to write into (a new one when
    None)."""
    expect(src, "src", ndim=3, last=3)
    expect(scores, "scores", shape=src.shape[:2], device=src.device)
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=src.shape[:2], device=src.device)
    b = src.shape[0]
    k = src.shape[1]
    if subset is not None:
        expect(subset, "subset", dtype=torch.int32, ndim=2, device=src.device)
        k = subset.shape[1]
        if subset.shape[0] != b or not 0 < k <= src.shape[1]:
            raise ValueError(f"subset {tuple(subset.shape)} does not fit src {tuple(src.shape)}")
    if out is not None:
        expect(out, "out", dtype=torch.int32 if keys else torch.float32, shape=(b, k),
               device=src.device)
    r2 = radius_sq(radius)
    if on_cuda(src):
        nms_local_max.launches += 1
        return _launch_flags(src.float(), scores.float(), mask, subset, gate, r2, keys, out)
    if out is None:
        out = torch.empty((b, k), dtype=torch.int32 if keys else torch.float32)
    if gate is not None and not _gate_open(gate):
        return out
    if subset is not None:
        idx = subset.long()
        src = torch.gather(src, 1, idx[..., None].expand(-1, -1, 3))
        scores = torch.gather(scores, 1, idx)
        mask = None if mask is None else torch.gather(mask, 1, idx)
    flags = nms_local_max_plain(src, scores, mask, r2)
    return out.copy_(_total_order_key(nms_key(scores.float(), flags, mask)) if keys else flags)


nms_local_max.launches = 0


def key_values(keys: torch.Tensor) -> torch.Tensor:
    """The floats of int32 total-order keys (the map is its own inverse)."""
    return (keys ^ ((keys >> 31) & 0x7FFFFFFF)).view(torch.float32)


def nms_select_plain(keys, k):
    """Plain version of the seed select: positions [B, k] from a stable
    descending sort of the int32 keys."""
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]


def select_workspace_size(k: int) -> int:
    """int32 entries a sample of the select's workspace: 2 x the power of
    two >= k (keys and positions) above ``SHARED_SELECT``, else 0."""
    return 0 if k <= SHARED_SELECT else 2 * (1 << (k - 1).bit_length())


def nms_select(keys, k, subset=None, gate=None, tau=None, cert=None, out=None, workspace=None):
    """Positions [B, k] int64 of the k largest of ``keys`` [B, K] (int32
    total-order keys), by key descending, ties to the lower position; with
    ``subset`` [B, K] (int32 indices, ascending) the indices it holds at
    those positions. With ``tau`` [B] f32 and ``cert`` [B] int32, writes
    the prefilter's certificate cert[b] = (k-th key > max(tau[b], 0)).
    ``gate`` as ``nms_local_max``'s; a gated-off call writes cert = 0 and
    leaves ``out`` as it was. ``out``: the [B, k] int64 result tensor to
    write into (a new one when None). ``workspace``: for k above
    ``SHARED_SELECT`` on the card, int32 [B, ``select_workspace_size(k)``]
    where the winners are sorted (a new one when None)."""
    expect(keys, "keys", dtype=torch.int32, ndim=2)
    b, n = keys.shape
    if not 0 < k <= n:
        raise ValueError(f"k = {k} for {n} keys")
    if subset is not None:
        expect(subset, "subset", dtype=torch.int32, shape=(b, n), device=keys.device)
    if (tau is None) != (cert is None):
        raise ValueError("tau and cert go together")
    if tau is not None:
        expect(tau, "tau", dtype=torch.float32, shape=(b,), device=keys.device)
        expect(cert, "cert", dtype=torch.int32, shape=(b,), device=keys.device)
    if out is None:
        out = torch.empty((b, k), dtype=torch.int64, device=keys.device)
    expect(out, "out", dtype=torch.int64, shape=(b, k), device=keys.device)
    if on_cuda(keys):
        gate_ptr, want = _gate_args(gate, b, keys.device)
        wide = select_workspace_size(k)
        if wide:
            if workspace is None:
                workspace = torch.empty((b, wide), dtype=torch.int32, device=keys.device)
            expect(workspace, "workspace", dtype=torch.int32, shape=(b, wide), device=keys.device)
        nms_select.launches += 1
        _build.launch("nms", "nms_select", keys.device, keys.data_ptr(),
                      None if subset is None else subset.data_ptr(), gate_ptr, want,
                      None if tau is None else tau.data_ptr(),
                      None if cert is None else cert.data_ptr(), out.data_ptr(),
                      workspace.data_ptr() if wide else None, b, n, k)
        return out
    if gate is not None and not _gate_open(gate):
        if cert is not None:
            cert.zero_()
        return out
    order = nms_select_plain(keys, k)
    out.copy_(order if subset is None else torch.gather(subset.long(), 1, order))
    if cert is not None:
        v = key_values(torch.gather(keys, 1, order[:, -1:]))[:, 0]
        cert.copy_(((v > tau) & (v > 0.0)).int())
    return out


nms_select.launches = 0


def nms_top_m_plain(scores, mask, m, s_need):
    """Plain version of the prefilter's select: (indices [B, m] int32 of the
    m largest masked scores in index order, the m-th score [B], whether at
    least s_need masked scores are > 0 [B] int32)."""
    ranked = scores.float()
    if mask is not None:
        ranked = torch.where(mask, ranked, torch.full_like(ranked, -float("inf")))
    top = top_k_like_jax(ranked, m)
    idx_m = torch.sort(top, dim=-1).values.int()
    tau = torch.gather(ranked, 1, top[:, -1:])[:, 0]
    pre_ok = (torch.sum(ranked > 0.0, dim=-1) >= s_need).int()
    return idx_m, tau, pre_ok


def nms_top_m(scores, mask, m, s_need, out=None):
    """The prefilter's select from scores [B, N] (mask [B, N] or None):
    indices [B, m] int32 of the m largest masked scores (invalid at -inf,
    ties to the lower index), in index order; tau [B] f32, the m-th
    largest; pre_ok [B] int32, 1 where at least s_need masked scores are
    > 0 (the certificate's precheck). ``out``: the three tensors to write
    into (new ones when None)."""
    expect(scores, "scores", ndim=2)
    b, n = scores.shape
    dev = scores.device
    if mask is not None:
        expect(mask, "mask", dtype=torch.bool, shape=(b, n), device=dev)
    if not 0 < m <= n:
        raise ValueError(f"m = {m} for {n} scores")
    if out is None:
        out = (torch.empty((b, m), dtype=torch.int32, device=dev),
               torch.empty((b,), dtype=torch.float32, device=dev),
               torch.empty((b,), dtype=torch.int32, device=dev))
    specs = (("idx_m", torch.int32, (b, m)), ("tau", torch.float32, (b,)),
             ("pre_ok", torch.int32, (b,)))
    for t, (name, dtype, shape) in zip(out, specs):
        expect(t, name, dtype=dtype, shape=shape, device=dev)
    if not on_cuda(scores):
        for t, r in zip(out, nms_top_m_plain(scores, mask, m, s_need)):
            t.copy_(r)
        return out
    idx_m, tau, pre_ok = out
    nms_top_m.launches += 1
    _build.launch("nms", "nms_top_m", dev, scores.float().data_ptr(),
                  None if mask is None else mask.data_ptr(), idx_m.data_ptr(), tau.data_ptr(),
                  pre_ok.data_ptr(), b, n, m, s_need)
    return out


nms_top_m.launches = 0


def pick_seeds_nms_fused(src, scores, radius, max_num, mask=None):
    """Same selection as ops.nms.pick_seeds_nms, from coordinates."""
    return nms_select(nms_local_max(src, scores, radius, mask=mask, keys=True), max_num)


def pick_seeds_gated(src, scores, radius, max_num, mask, m):
    """The prefiltered selection with both decisions taken where the data
    lies, as JAX's ``lax.cond`` takes them: five launches whatever the
    branch, no host sync on the card. The subset's flags and select run
    only if every sample has max_num positive scores (the precheck); the
    full grid's only if some sample's certificate fails, and then over the
    whole batch. The intermediates, and the two selects' sort space when
    max_num is above ``SHARED_SELECT``, share one int32 workspace.

    Returns the seeds [B, max_num] int64 and each sample's precheck and
    certificate [B] int32 (the branch taken, read without a sync)."""
    b, n = scores.shape
    wide = select_workspace_size(max_num)
    ws = torch.empty(b * (2 * m + n + 3 + wide), dtype=torch.int32, device=scores.device)
    idx_m, key_m, keys, sort_space = (ws[o * b:(o + w) * b].view(b, w) for o, w in (
        (0, m), (m, m), (2 * m, n), (2 * m + n + 3, wide)))
    tau, pre_ok, cert = (ws[(2 * m + n + i) * b:(2 * m + n + i + 1) * b] for i in range(3))
    tau = tau.view(torch.float32)
    nms_top_m(scores, mask, m, max_num, out=(idx_m, tau, pre_ok))
    nms_local_max(src, scores, radius, mask=mask, subset=idx_m, gate=(pre_ok, 1), keys=True,
                  out=key_m)
    seeds = nms_select(key_m, max_num, subset=idx_m, gate=(pre_ok, 1), tau=tau, cert=cert,
                       workspace=sort_space)
    nms_local_max(src, scores, radius, mask=mask, gate=(cert, 0), keys=True, out=keys)
    seeds = nms_select(keys, max_num, gate=(cert, 0), out=seeds, workspace=sort_space)
    return seeds, pre_ok, cert


def pick_seeds_nms_prefiltered(src, scores, radius, max_num, mask=None, prefilter=None):
    """Exact NMS seed picking through a top-M score prefilter (large N).

    Any suppressor of a top-M point has a strictly higher score, so it is in
    the top-M set too, and flags computed within that subset are exact for
    its members. The subset's selection equals the full one whenever the
    max_num-th selected key strictly exceeds max(tau_M, 0), tau_M being the
    M-th score (the certificate); otherwise the full kernel runs. A
    positivity precheck skips the subset when the certificate cannot pass.
    Both decisions gate launches (``pick_seeds_gated``).
    """
    n = src.shape[-2]
    if prefilter is None:
        prefilter = max(4 * max_num, 4096)
    # the same rounding as the JAX entry: a 1024 multiple, at least max_num
    m = -(-max(prefilter, max_num) // 1024) * 1024
    if 2 * m > n:
        # the prefilter pays only when it prunes most of the pair grid
        return pick_seeds_nms_fused(src, scores, radius, max_num, mask=mask)
    return pick_seeds_gated(src, scores, radius, max_num, mask, m)[0]
