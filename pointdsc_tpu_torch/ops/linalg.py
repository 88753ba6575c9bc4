"""Small symmetric eigensolvers (PyTorch counterpart of
``pointdsc_tpu/ops/linalg.py``): the branch-free cyclic Jacobi of
``jacobi_eigh`` (3x3 normals, the ``method="jacobi"`` Procrustes) and the
closed-form dominant eigenpair of batched symmetric 4x4 matrices.

Kept as the same algorithms, not ``torch.linalg.eigh``: the sweeps, the
Newton steps, the adjugate column and the degenerate fallback to e0 decide
the numbers that the JAX package gives, and the port is held to them.

The Jacobi rotations are also rounded as the JAX package's CPU run rounds
them, so that a rank-deficient matrix (a normal from two neighbours: which
vector of the null plane comes out is decided by rounding) gives the same
eigenvectors: each square root correctly rounded (``sqrt_rn``; PyTorch's CPU
``sqrt`` of float32 is not, in ~0.6% of cases), and each 3-deep matrix
product as XLA's CPU dot forms it (``fma_matmul``).
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float32 ``x`` (through float64,
    whose 53 bits make the second rounding exact), on the CPU as on the
    card."""
    return torch.sqrt(x.double()).to(x.dtype)


def fma_chain(terms) -> torch.Tensor:
    """sum_k a_k b_k over float32 pairs (a_k, b_k) as XLA's CPU dot and
    einsum form it: the first product rounded, then one fused multiply-add
    per term, in order. The fused multiply-add is emulated in float64, where
    the product of two float32 values is exact, and rounded once to float32."""
    terms = iter(terms)
    a, b = next(terms)
    acc = a * b
    for a, b in terms:
        acc = (a.double() * b.double() + acc.double()).to(a.dtype)
    return acc


def fma_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched x @ y [..., n, m] @ [..., m, p], every entry an ``fma_chain``
    over the inner dimension."""
    cols = [[fma_chain((x[..., i, k], y[..., k, j]) for k in range(x.shape[-1]))
             for j in range(y.shape[-1])] for i in range(x.shape[-2])]
    return torch.stack([torch.stack(row, dim=-1) for row in cols], dim=-2)


def _jacobi_rotation_pair(A: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One batched Jacobi rotation zeroing A[..., p, q] (p < q).

    t = tan(theta) in the division-safe form 2 apq sign(d) / (|d| +
    hypot(2 apq, d)), d = aqq - app: bounded, 0 when apq = 0, +-1 when d = 0,
    and never a division by a vanishing quantity."""
    n = A.shape[-1]
    app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
    d = aqq - app
    sgn_d = torch.where(d >= 0, 1.0, -1.0).to(A.dtype)
    hyp = sqrt_rn(4.0 * apq * apq + d * d + 1e-36)
    t = 2.0 * apq * sgn_d / (torch.abs(d) + hyp)
    c = 1.0 / sqrt_rn(1.0 + t * t)
    s = t * c

    G = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    G[..., p, p] = c
    G[..., q, q] = c
    G[..., p, q] = s
    G[..., q, p] = -s
    A_new = fma_matmul(fma_matmul(G.transpose(-1, -2), A), G)
    V_new = fma_matmul(V, G)
    A_new[..., p, q] = 0.0
    A_new[..., q, p] = 0.0
    return A_new, V_new


def jacobi_eigh(A: torch.Tensor, sweeps: int = 10):
    """Eigendecomposition of small batched symmetric matrices [..., n, n] by
    ``sweeps`` cyclic Jacobi sweeps over the n(n-1)/2 pairs. Returns
    (eigvals [..., n] ascending, eigvecs [..., n, n] as columns)."""
    n = A.shape[-1]
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    for _ in range(sweeps):
        for p, q in pairs:
            A, V = _jacobi_rotation_pair(A, V, p, q)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w_sorted = torch.gather(w, -1, order)
    V_sorted = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w_sorted, V_sorted


def symeig3x3(A: torch.Tensor, sweeps: int = 8):
    """Eigendecomposition of batched symmetric 3x3 matrices (ascending)."""
    assert A.shape[-1] == 3 and A.shape[-2] == 3
    return jacobi_eigh(A, sweeps=sweeps)


def symeig4x4(A: torch.Tensor, sweeps: int = 10):
    """Eigendecomposition of batched symmetric 4x4 matrices (ascending)."""
    assert A.shape[-1] == 4 and A.shape[-2] == 4
    return jacobi_eigh(A, sweeps=sweeps)


def _det3_of(m, rows, cols):
    """3x3 determinant of the submatrix m[..., rows, cols] (static indices)."""
    r0, r1, r2 = rows
    c0, c1, c2 = cols
    a, b, c = m[..., r0, c0], m[..., r0, c1], m[..., r0, c2]
    d, e, f = m[..., r1, c0], m[..., r1, c1], m[..., r1, c2]
    g, h, i = m[..., r2, c0], m[..., r2, c1], m[..., r2, c2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _det4(m):
    """Determinant of batched 4x4 matrices by cofactor expansion (row 0)."""
    cols = (0, 1, 2, 3)
    out = 0.0
    sign = 1.0
    for j in range(4):
        rest = tuple(c for c in cols if c != j)
        out = out + sign * m[..., 0, j] * _det3_of(m, (1, 2, 3), rest)
        sign = -sign
    return out


def _adjugate4_sym(m):
    """Adjugate of batched symmetric 4x4 matrices (upper triangle computed,
    mirrored): adj(A)_ij = (-1)^(i+j) * minor_ji."""
    idx = (0, 1, 2, 3)
    entries = {}
    for i in range(4):
        for j in range(i, 4):
            rows = tuple(r for r in idx if r != j)
            cols = tuple(c for c in idx if c != i)
            entries[(i, j)] = ((-1.0) ** (i + j)) * _det3_of(m, rows, cols)
    rows_out = []
    for i in range(4):
        row = [entries[(min(i, j), max(i, j))] for j in range(4)]
        rows_out.append(torch.stack(row, dim=-1))
    return torch.stack(rows_out, dim=-2)


def dominant_eigvec4x4(A: torch.Tensor, newton_iters: int = 14):
    """Largest eigenvalue + unit eigenvector of batched symmetric 4x4 A.

    Shift by trace/4, scale by the Frobenius norm, run Newton from x0 = 1 on
    the characteristic quartic (monotone from above), and take the
    largest-diagonal column of adj(B - lambda I). Degenerate inputs
    (multiple largest eigenvalue, zero matrix) fall back to e0.
    Returns (eigval [...], eigvec [..., 4]).
    """
    assert A.shape[-1] == 4 and A.shape[-2] == 4
    A = 0.5 * (A + A.transpose(-1, -2))
    mu = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 4.0
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    B = A - mu[..., None, None] * eye
    fro = torch.sqrt(torch.sum(B * B, dim=(-1, -2)))
    scale = torch.clamp(fro, min=1e-30)
    Bn = B / scale[..., None, None]

    B2 = Bn @ Bn
    tr2 = torch.diagonal(B2, dim1=-2, dim2=-1).sum(-1)
    e3 = torch.sum(B2 * Bn, dim=(-1, -2)) / 3.0
    e4 = _det4(Bn)
    c2 = -0.5 * tr2

    lam = torch.ones_like(tr2)
    for _ in range(newton_iters):
        lam2 = lam * lam
        p = lam2 * lam2 + c2 * lam2 - e3 * lam + e4
        dp = 4.0 * lam2 * lam + 2.0 * c2 * lam - e3
        lam = lam - p / torch.clamp(dp, min=1e-12)

    C = Bn - lam[..., None, None] * eye
    adj = _adjugate4_sym(C)
    diag = torch.abs(torch.diagonal(adj, dim1=-2, dim2=-1))
    col = torch.argmax(diag, dim=-1)
    v = torch.gather(adj, -1, col[..., None, None].expand(adj.shape[:-1] + (1,)))[..., 0]
    nv = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    fallback = torch.zeros_like(v)
    fallback[..., 0] = 1.0
    tiny = 1e-20
    v = torch.where(nv > tiny, v / torch.clamp(nv, min=tiny), fallback)
    return lam * scale + mu, v
