"""Pose-graph optimization: robust Gauss-Newton over SE(3) (PyTorch
counterpart of ``pointdsc_tpu/multiway/pose_graph.py``).

Replaces Open3D's ``global_optimization`` (LM + line-process edge pruning)
of the reference multiway pipeline, after Choi, Zhou and Koltun 2015:

  minimize  sum_e  l_e * r_e^T  Info_e  r_e  +  mu * (sqrt(l_e) - 1)^2

with r_e = log(inv(T_meas) inv(T_i) T_j) and, for *uncertain* (loop-closure)
edges, the closed-form line-process weight l_e = (mu / (mu + r^T Info r))^2;
odometry edges keep l = 1.

Each Gauss-Newton step differentiates the per-edge residual with respect to
its two 6-dof increments at zero (``torch.func.vmap`` of ``jacrev``, as the
JAX package's ``jax.vmap(jax.jacrev(...))``), scatters the [E, 6, 6] blocks
into the dense [6n, 6n] normal equations and solves them. Everything runs in
float32 on ``device``; the kept edges are read back once at the end.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.ops.lie import se3_exp, se3_log


@dataclass
class PoseGraphEdge:
    source: int
    target: int
    transformation: np.ndarray  # [4, 4] measured T_st: source -> target frame
    information: np.ndarray  # [6, 6]
    uncertain: bool = True


@dataclass
class PoseGraph:
    poses: list  # list of [4, 4] node poses (node -> world)
    edges: list = field(default_factory=list)


def _edge_r(xi_i, xi_j, Ti, Tj, mi):
    """One edge's residual after left increments xi_i, xi_j of its nodes."""
    Ti2 = se3_exp(xi_i) @ Ti
    Tj2 = se3_exp(xi_j) @ Tj
    return se3_log(mi @ torch.linalg.inv(Ti2) @ Tj2)


_edge_jacobians = torch.func.vmap(torch.func.jacrev(_edge_r, argnums=(0, 1)))


def _gn_iteration(poses, src_idx, tgt_idx, meas_inv, infos, weights, num_nodes: int,
                  damping: float):
    """One damped GN step. poses [n, 4, 4]; edge arrays stacked over edges.
    Returns the new poses."""
    E = src_idx.shape[0]
    zero6 = torch.zeros((E, 6), dtype=poses.dtype, device=poses.device)
    Ti, Tj = poses[src_idx], poses[tgt_idx]
    r0 = _edge_r(zero6, zero6, Ti, Tj, meas_inv)  # [E, 6]
    # jacrev inside an outer no_grad (the CLIs' eval mode) gives wrong
    # Jacobians for this residual (off by up to ~2e4 on random edges)
    with torch.enable_grad():
        Ji, Jj = _edge_jacobians(zero6, zero6, Ti, Tj, meas_inv)  # each [E, 6, 6]

    W = weights[:, None, None] * infos  # [E, 6, 6]
    Wr = torch.einsum("eij,ej->ei", W, r0)
    bi = torch.einsum("eri,er->ei", Ji, Wr)
    bj = torch.einsum("eri,er->ei", Jj, Wr)
    Hii = torch.einsum("eri,erj->eij", Ji, torch.einsum("ers,esj->erj", W, Ji))
    Hij = torch.einsum("eri,erj->eij", Ji, torch.einsum("ers,esj->erj", W, Jj))
    Hjj = torch.einsum("eri,erj->eij", Jj, torch.einsum("ers,esj->erj", W, Jj))

    # scatter the blocks: node pair (a, b) is flat block a * n + b
    n = num_nodes
    Hb = torch.zeros((n * n, 6, 6), dtype=poses.dtype, device=poses.device)
    Hb.index_add_(0, src_idx * n + src_idx, Hii)
    Hb.index_add_(0, src_idx * n + tgt_idx, Hij)
    Hb.index_add_(0, tgt_idx * n + src_idx, Hij.transpose(-1, -2))
    Hb.index_add_(0, tgt_idx * n + tgt_idx, Hjj)
    H = Hb.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(n * 6, n * 6)
    b = torch.zeros((n, 6), dtype=poses.dtype, device=poses.device)
    b.index_add_(0, src_idx, bi)
    b.index_add_(0, tgt_idx, bj)
    # gauge freedom: anchor node 0 by a strong prior
    diag = torch.full((n * 6,), damping, dtype=poses.dtype, device=poses.device)
    diag[:6] += 1e6
    H = H + torch.diag(diag)
    delta = -torch.linalg.solve(H, b.reshape(n * 6))
    return se3_exp(delta.reshape(n, 6)) @ poses


def _line_process_weights(poses, src_idx, tgt_idx, meas_inv, infos, uncertain, mu):
    r = se3_log(meas_inv @ torch.linalg.inv(poses[src_idx]) @ poses[tgt_idx])
    quad = torch.einsum("ei,eij,ej->e", r, infos, r)
    l = (mu / (mu + quad)) ** 2
    return torch.where(uncertain, l, torch.ones_like(l))


@full_f32_matmul()
def optimize_pose_graph(graph: PoseGraph, max_correspondence_distance: float = 0.07,
                        edge_prune_threshold: float = 0.25,
                        preference_loop_closure: float = 20.0, gn_iters: int = 30,
                        outer_iters: int = 5, damping: float = 1e-6,
                        device: str | torch.device = "cuda") -> PoseGraph:
    """Robust pose-graph optimization with the Open3D option set of the
    reference (optimize_posegraph.py:33-42): ``max_correspondence_distance``
    sets the line process's mu = preference * d_max^2, and uncertain edges
    whose final weight is below ``edge_prune_threshold`` are pruned.
    ``gn_iters`` GN steps run in ``outer_iters`` rounds, the weights
    recomputed after each round."""
    dev = resolve_device(device)
    if not graph.edges:
        return graph
    n = len(graph.poses)
    f32 = dict(dtype=torch.float32, device=dev)
    poses = torch.as_tensor(np.stack(graph.poses), **f32)
    src_idx = torch.as_tensor([e.source for e in graph.edges], dtype=torch.int64, device=dev)
    tgt_idx = torch.as_tensor([e.target for e in graph.edges], dtype=torch.int64, device=dev)
    meas_inv = torch.as_tensor(
        np.stack([np.linalg.inv(e.transformation) for e in graph.edges]), **f32)
    infos = torch.as_tensor(np.stack([e.information for e in graph.edges]), **f32)
    # normalize information magnitude so mu is on a comparable scale
    infos = infos / torch.clamp(infos[:, 5, 5], min=1.0)[:, None, None]
    uncertain = torch.as_tensor([e.uncertain for e in graph.edges], device=dev)
    mu = torch.tensor(preference_loop_closure * max_correspondence_distance ** 2, **f32)

    weights = torch.ones((len(graph.edges),), **f32)
    for _ in range(outer_iters):
        for _ in range(gn_iters // outer_iters):
            poses = _gn_iteration(poses, src_idx, tgt_idx, meas_inv, infos, weights, n,
                                  damping)
        weights = _line_process_weights(poses, src_idx, tgt_idx, meas_inv, infos, uncertain,
                                        mu)

    weights_np = weights.cpu().numpy()
    kept = [e for e, w in zip(graph.edges, weights_np)
            if (not e.uncertain) or w >= edge_prune_threshold]
    return PoseGraph(poses=list(poses.cpu().numpy()), edges=kept)
