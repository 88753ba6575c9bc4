"""Classical registration baselines (the port's counterpart of
``pointdsc_tpu/baselines/classical.py``): SM, RANSAC, GC-RANSAC, LS and PMC
under the reference's stats protocol (its baseline_scripts/
baseline_3DMatch.py:19-123,176-193).

Every function works on the device of its input tensors, with float32
matrix products in full float32 (``full_f32_matmul``): under TF32 the gram
distances and the power iteration's ``M @ v`` lose ~1e-3 and move the
leading vector. RANSAC and GC-RANSAC draw their minimal sets through
``draw_minimal_sets`` from a CPU ``torch.Generator``, so a run on the card
and one on the CPU with the same seed draw the same sets. The hypothesis
sweep runs in chunks of hypotheses, whose integer inlier counts give the
same first argmax as one sweep. PMC keeps the native exact max-clique solver
(``native/max_clique.cpp``) and GC-RANSAC's ``minimizer="exact"`` the native
s-t mincut (``native/maxflow.cpp``), both on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.ops.eig import power_iteration
from pointdsc_tpu_torch.ops.knn import pairwise_sq_dists
from pointdsc_tpu_torch.ops.procrustes import weighted_procrustes
from pointdsc_tpu_torch.ops.se3 import transform

# hypotheses x points of one chunk of the sweep: its [B, chunk, N, 3]
# predictions take ~200 MB in float32
SWEEP_ELEMENTS = 1 << 24


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """Squared norm over the last axis of size 3, summed x, y, z in order."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3. On the CPU the square
    root is taken in float64 and rounded: torch's vectorised float32 sqrt
    there can be 1 ulp off the correctly rounded one, which the threshold
    tests would see."""
    sq = _sq_norm(v)
    if sq.device.type == "cpu":
        return torch.sqrt(sq.double()).to(sq.dtype)
    return torch.sqrt(sq)


def _take_nbr(vec: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """[B, N] x [B, N, k] -> [B, N, k]: vec[b, nbr[b, i, j]]."""
    b, n, k = nbr.shape
    return torch.gather(vec, 1, nbr.reshape(b, n * k)).reshape(b, n, k)


def _smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row, ties to the lower
    index (``lax.top_k`` of -d): a stable sort."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def draw_minimal_sets(b: int, h: int, n: int, generator: torch.Generator | None,
                      device) -> torch.Tensor:
    """[b, h, 3] int64 point indices in [0, n), drawn on the CPU from
    ``generator`` and sent to ``device`` in one copy. Duplicates within a
    set are allowed, and masked points are drawn too, as in the JAX
    package."""
    idx = torch.randint(0, n, (b, h, 3), generator=generator, dtype=torch.int64)
    return idx.to(device)


def _hypotheses(src: torch.Tensor, tgt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, H, 4, 4] rigid fits of the minimal sets idx [B, H, 3]."""
    rows = torch.arange(src.shape[0], device=src.device)[:, None, None]
    return weighted_procrustes(src[rows, idx], tgt[rows, idx])


def _best_hypothesis(src, tgt, hyp, mask, inlier_threshold) -> torch.Tensor:
    """[B, 4, 4]: the hypothesis with the most inliers (the first of equal
    counts), swept in chunks of hypotheses."""
    b, h = hyp.shape[:2]
    chunk = max(1, SWEEP_ELEMENTS // max(1, b * src.shape[1]))
    fitness = []
    for lo in range(0, h, chunk):
        part = hyp[:, lo:lo + chunk]
        pred = torch.einsum("bhij,bnj->bhni", part[..., :3, :3], src) + part[..., None, :3, 3]
        inlier = (_norm(pred - tgt[:, None]) < inlier_threshold) & mask[:, None]
        fitness.append(inlier.sum(dim=-1))
    best = torch.argmax(torch.cat(fitness, dim=1), dim=-1)
    return hyp[torch.arange(b, device=hyp.device), best]


def _default_mask(src: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.ones(src.shape[:2], dtype=torch.bool, device=src.device)
    return mask


@torch.no_grad()
@full_f32_matmul()
def spectral_matching(src_keypts: torch.Tensor, tgt_keypts: torch.Tensor,
                      inlier_threshold: float = 0.10, top_ratio: float = 0.1,
                      num_iters: int = 10):
    """Classical spectral matching (Leordeanu & Hebert) with the reference's
    polynomial compatibility (baseline_3DMatch.py:35-38):
    M = max(0, 4.5 - d^2 / (2 sigma^2)), sigma = tau / 3, zero diagonal, on
    the gram-form distances. The top (ratio N) entries of the leading
    eigenvector, ties to the lower index, are the inliers; the transform is
    the weighted Procrustes fit with eigenvector-weighted labels.
    src_keypts, tgt_keypts: [B, N, 3]. Returns ([B, 4, 4], labels [B, N])."""
    n = src_keypts.shape[1]
    d = torch.sqrt(pairwise_sq_dists(src_keypts)) - torch.sqrt(pairwise_sq_dists(tgt_keypts))
    sigma = inlier_threshold / 3.0
    M = torch.clamp(4.5 - d * d / (2.0 * sigma * sigma), min=0.0)
    del d
    M.diagonal(dim1=-2, dim2=-1).zero_()

    leading = power_iteration(M, num_iters)  # [B, N]
    del M
    k = max(1, int(n * top_ratio))
    ids = torch.sort(leading, dim=-1, descending=True, stable=True).indices[:, :k]
    pred_labels = torch.zeros_like(leading).scatter_(1, ids, 1.0)
    trans = weighted_procrustes(src_keypts, tgt_keypts, leading * pred_labels)
    return trans, pred_labels


@torch.no_grad()
@full_f32_matmul()
def ransac_registration(src_keypts: torch.Tensor, tgt_keypts: torch.Tensor,
                        generator: torch.Generator | None = None,
                        inlier_threshold: float = 0.10, num_hypotheses: int = 4096,
                        refit_iters: int = 3, mask: torch.Tensor | None = None):
    """Correspondence RANSAC (the reference's Open3D call,
    baseline_3DMatch.py:80-98): ``num_hypotheses`` minimal 3-point sets from
    ``generator`` (a CPU generator; ``draw_minimal_sets``), their rigid fits,
    inliers counted in chunks of hypotheses, the winner re-fit on its
    inliers ``refit_iters`` times. src_keypts, tgt_keypts: [B, N, 3]; mask
    [B, N] bool. Returns ([B, 4, 4], labels [B, N] float32)."""
    b, n, _ = src_keypts.shape
    mask = _default_mask(src_keypts, mask)
    idx = draw_minimal_sets(b, num_hypotheses, n, generator, src_keypts.device)
    hyp = _hypotheses(src_keypts, tgt_keypts, idx)
    trans = _best_hypothesis(src_keypts, tgt_keypts, hyp, mask, inlier_threshold)

    for _ in range(refit_iters):
        d = _norm(transform(src_keypts, trans) - tgt_keypts)
        w = ((d < inlier_threshold) & mask).float()
        trans = weighted_procrustes(src_keypts, tgt_keypts, w)
    d = _norm(transform(src_keypts, trans) - tgt_keypts)
    return trans, ((d < inlier_threshold) & mask).float()


@torch.no_grad()
@full_f32_matmul()
def least_squares_fit(src_keypts: torch.Tensor, tgt_keypts: torch.Tensor,
                      gt_labels: torch.Tensor):
    """Diagnostic LS baseline on the gt inliers (baseline_3DMatch.py:176-193):
    the unconstrained affine fit B ~ T A in homogeneous coordinates by the
    normal equations with a 1e-6 ridge (not restricted to SE(3)). Returns
    ([B, 4, 4], gt_labels)."""
    w = gt_labels.to(src_keypts.dtype)[..., None]
    ones = torch.ones_like(src_keypts[..., :1])
    A = torch.cat([src_keypts, ones], dim=-1) * w  # [B, N, 4]
    B = torch.cat([tgt_keypts, ones], dim=-1) * w
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    AtA = torch.einsum("bni,bnj->bij", A, A) + 1e-6 * eye
    AtB = torch.einsum("bni,bnj->bij", A, B)
    return torch.linalg.solve(AtA, AtB).transpose(-1, -2), gt_labels


@torch.no_grad()
def coherence_icm(r2, nbr, nbr_valid, mask, lam, icm_sweeps=10):
    """ICM minimisation of the Barath & Matas coherence energy for fixed
    normalised squared residuals r2 = d^2 / tau^2 ([B, N]):

        E(L) = sum_i [ L_i * min(r2_i, 1) + (1 - L_i) * max(1 - r2_i, 0) ]
             + (lam / 2) * sum_i sum_{j in kNN(i)} [L_i != L_j]

    Parallel (Jacobi) label sweeps from the thresholded labels; nbr [B, N, k]
    int64, nbr_valid [B, N, k] and mask [B, N] bool. Returns (energy [B],
    labels [B, N] bool)."""
    c_in = torch.clamp(r2, max=1.0)  # cost of labelling inlier (1 - K)
    c_out = torch.clamp(1.0 - r2, min=0.0)  # cost of labelling outlier (K)
    L = (r2 < 1.0) & mask
    nv = nbr_valid.float()
    for _ in range(icm_sweeps):
        nbr_L = _take_nbr(L.float(), nbr)
        agree_in = torch.sum((1.0 - nbr_L) * nv, dim=-1)  # disagreements if inlier
        agree_out = torch.sum(nbr_L * nv, dim=-1)
        L = (c_in + lam * agree_in < c_out + lam * agree_out) & mask
    Lf = L.float()
    nbr_L = _take_nbr(Lf, nbr)
    pair_E = lam * torch.sum(torch.abs(Lf[..., None] - nbr_L) * nv, dim=(-1, -2)) * 0.5
    unary_E = torch.sum(torch.where(mask, Lf * c_in + (1.0 - Lf) * c_out,
                                    torch.zeros_like(Lf)), dim=-1)
    return unary_E + pair_E, L


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def coherence_mincut(r2, nbr, nbr_valid, mask, lam):
    """The exact global minimum of ``coherence_icm``'s energy (the same
    semantics: lam / 2 per directed kNN edge, masked nodes forced to outlier
    at zero unary cost) by the native s-t mincut (``native/maxflow.cpp``,
    Dinic): the energy is binary submodular (Potts), so the cut is the true
    optimum, as pygcransac's graph cut (baseline_3DMatch.py:101-123). Runs on
    the host; each argument is a tensor on any device or an array. Returns
    (energy [B] float32, labels [B, N] bool), on r2's device."""
    from pointdsc_tpu_torch.native import mincut_labels

    device = r2.device if isinstance(r2, torch.Tensor) else torch.device("cpu")
    r2 = _host(r2).astype(np.float64)
    nbr, nv, mk = _host(nbr), _host(nbr_valid), _host(mask)
    bsz, n = r2.shape
    energies = np.zeros(bsz, np.float32)
    labels = np.zeros((bsz, n), bool)
    c_in_all = np.minimum(r2, 1.0)
    c_out_all = np.maximum(1.0 - r2, 0.0)
    ii = np.repeat(np.arange(n, dtype=np.int32), nbr.shape[-1])
    for bidx in range(bsz):
        jj = nbr[bidx].reshape(-1).astype(np.int32)
        keep = nv[bidx].reshape(-1)
        w = np.full(int(keep.sum()), lam * 0.5)
        c_in = np.where(mk[bidx], c_in_all[bidx], np.inf)
        c_out = np.where(mk[bidx], c_out_all[bidx], 0.0)
        energies[bidx], labels[bidx] = mincut_labels(ii[keep], jj[keep], w, c_in, c_out, n)
    return torch.from_numpy(energies).to(device), torch.from_numpy(labels).to(device)


@torch.no_grad()
@full_f32_matmul()
def gc_ransac_registration(src_keypts: torch.Tensor, tgt_keypts: torch.Tensor,
                           generator: torch.Generator | None = None,
                           inlier_threshold: float = 0.10, num_hypotheses: int = 4096,
                           spatial_coherence_weight: float = 0.1, lo_iters: int = 4,
                           icm_sweeps: int = 10, knn_k: int = 8,
                           mask: torch.Tensor | None = None, minimizer: str = "icm"):
    """Graph-Cut RANSAC (the reference calls ``pygcransac.findRigidTransform``
    with spatial_coherence_weight = 0.1, baseline_3DMatch.py:101-123).

    After the hypothesis sweep of ``ransac_registration`` (the same draws),
    the inlier labelling minimises the spatially coherent energy of
    ``coherence_icm`` over the k-NN graph of the source keypoints (ties to the
    lower index; a valid point with fewer than ``knn_k`` valid others lists
    itself, an edge that then votes), followed by a re-fit weighted
    L / (1 + (d / tau)^2); ``lo_iters`` rounds and the final iterate, the
    lowest energy kept. ``minimizer``: "icm", the parallel sweeps on the
    device, or "exact", the native mincut on the host (one copy of r2 to the
    host and of the result back per round). Returns ([B, 4, 4], labels
    [B, N] float32)."""
    if minimizer not in ("icm", "exact"):
        raise ValueError(f"minimizer must be 'icm' or 'exact', got {minimizer}")
    b, n, _ = src_keypts.shape
    mask = _default_mask(src_keypts, mask)
    lam = spatial_coherence_weight
    tau2 = inlier_threshold * inlier_threshold

    # spatial kNN graph over the source keypoints (masked points isolated)
    d_spatial = torch.sqrt(pairwise_sq_dists(src_keypts))
    d_spatial = d_spatial.masked_fill(~mask[:, None, :], float("inf"))
    d_spatial.diagonal(dim1=-2, dim2=-1).add_(1e9)  # no self edges
    nbr = _smallest_k(d_spatial, knn_k)  # [B, N, k]
    del d_spatial
    nbr_valid = _take_nbr(mask, nbr) & mask[..., None]
    if minimizer == "exact":
        graph = (_host(nbr), _host(nbr_valid), _host(mask))  # fixed over the rounds

    idx = draw_minimal_sets(b, num_hypotheses, n, generator, src_keypts.device)
    hyp = _hypotheses(src_keypts, tgt_keypts, idx)
    trans = _best_hypothesis(src_keypts, tgt_keypts, hyp, mask, inlier_threshold)

    def energy_and_labels(trans):
        r2 = _sq_norm(transform(src_keypts, trans) - tgt_keypts) / tau2
        if minimizer == "exact":
            return coherence_mincut(r2, *graph, lam)
        return coherence_icm(r2, nbr, nbr_valid, mask, lam, icm_sweeps)

    best_E = torch.full((b,), float("inf"), device=src_keypts.device)
    best_trans = trans
    best_L = torch.zeros_like(mask)
    for step in range(lo_iters + 1):  # the last round scores the final iterate
        E, L = energy_and_labels(trans)
        better = E < best_E
        best_E = torch.where(better, E, best_E)
        best_trans = torch.where(better[:, None, None], trans, best_trans)
        best_L = torch.where(better[:, None], L, best_L)
        if step == lo_iters:
            break
        # re-fit on the coherent labelling (Geman-McClure-like weights)
        d = _norm(transform(src_keypts, trans) - tgt_keypts)
        w = L.float() / (1.0 + (d / inlier_threshold) ** 2)
        trans = weighted_procrustes(src_keypts, tgt_keypts, w)
    return best_trans, best_L.float()


def gc_ransac_registration_pygc(src_keypts: np.ndarray, tgt_keypts: np.ndarray,
                                inlier_threshold: float = 0.10, max_iters: int = 100000):
    """Optional adapter over the original pygcransac (an exact s-t mincut),
    the reference's call (baseline_3DMatch.py:101-123), for one pair on the
    host. Raises ImportError where pygcransac is not installed."""
    import pygcransac

    pose, mask_ = pygcransac.findRigidTransform(
        np.ascontiguousarray(src_keypts, np.float64),
        np.ascontiguousarray(tgt_keypts, np.float64),
        threshold=inlier_threshold,
        conf=0.99999999,
        spatial_coherence_weight=0.1,
        max_iters=max_iters,
        use_sprt=True,
        min_inlier_ratio_for_sprt=0.1,
    )
    if mask_.sum() == 0:
        pose = np.eye(4)
    return pose.T, mask_.astype(np.float32)


def pmc_registration(src_keypts: np.ndarray, tgt_keypts: np.ndarray,
                     inlier_threshold: float = 0.10, device: str | torch.device = "cuda"):
    """Max-clique registration (baseline PMC, baseline_3DMatch.py:56-77) of
    one pair on the host ([N, 3] arrays): vertices are the correspondences,
    edges join those whose lengths differ by less than tau; the exact
    maximum clique by the native solver (``native/max_clique.cpp``); the
    transform is the Procrustes fit on the clique, on ``device``. Returns
    ([4, 4] float32 array, labels [N] float32 array)."""
    from pointdsc_tpu_torch.native import max_clique

    dev = resolve_device(device)
    n = src_keypts.shape[0]
    d = np.linalg.norm(
        src_keypts[:, None] - src_keypts[None], axis=-1
    ) - np.linalg.norm(tgt_keypts[:, None] - tgt_keypts[None], axis=-1)
    compat = np.abs(d) < inlier_threshold
    iu, ju = np.nonzero(np.triu(compat, 1))
    clique = max_clique(iu.astype(np.int32), ju.astype(np.int32), n)

    labels = np.zeros(n, dtype=np.float32)
    labels[clique] = 1.0
    src, tgt, w = (torch.as_tensor(np.asarray(a, np.float32))[None].to(dev)
                   for a in (src_keypts, tgt_keypts, labels))
    with torch.no_grad(), full_f32_matmul():
        trans = weighted_procrustes(src, tgt, w)
    return trans[0].cpu().numpy(), labels
