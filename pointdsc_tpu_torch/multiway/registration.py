"""Multiway registration: fragments -> pose graph -> globally consistent poses
(PyTorch counterpart of ``pointdsc_tpu/multiway/registration.py``).

Rebuilds the reference's test_multi_ate.py:54-227 without Open3D:
  * odometry pairs (j = i + 1): multi-scale ICP from an initial guess;
  * loop-closure pairs: the given (PointDSC) transform, dropped when the
    information-matrix overlap info[5, 5] / min(N_i, N_j) is below
    ``min_overlap`` or the transform is exactly the identity
    (test_multi_ate.py:147-149);
  * robust pose-graph optimization (multiway/pose_graph.py);
  * optionally a second pass: ICP-refine every surviving edge and
    re-optimize (test_multi_ate.py:183-227).

ICP and the information matrix search nearest neighbours through
``kernels/nn_search.py`` (the CUDA kernel on the card): 50 + 30 + 14
searches and one more for the information matrix per odometry pair.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device
from pointdsc_tpu_torch.descriptors.fpfh import voxel_downsample
from pointdsc_tpu_torch.multiway.pose_graph import PoseGraph, PoseGraphEdge, optimize_pose_graph
from pointdsc_tpu_torch.ops.icp import icp_point_to_point, information_matrix


@full_f32_matmul()
def multi_scale_icp(src_pts: np.ndarray, tgt_pts: np.ndarray, init_trans: np.ndarray,
                    voxel_sizes=(0.05, 0.025, 0.0125), max_iters=(50, 30, 14),
                    distance_threshold: float = 0.05 * 1.4,
                    device: str | torch.device = "cuda"):
    """Coarse-to-fine ICP on voxel-downsampled clouds (test_multi_ate.py:54-74).
    Returns (trans [4, 4] float32, information [6, 6] float32), numpy; the
    information matrix of the last scale at 1.4 times its voxel."""
    dev = resolve_device(device)
    trans = torch.as_tensor(np.asarray(init_trans, np.float32), device=dev)
    info = None
    for stage, (v, it) in enumerate(zip(voxel_sizes, max_iters)):
        src_d = torch.as_tensor(voxel_downsample(np.asarray(src_pts, np.float64), v), device=dev)
        tgt_d = torch.as_tensor(voxel_downsample(np.asarray(tgt_pts, np.float64), v), device=dev)
        trans, _, _ = icp_point_to_point(src_d, tgt_d, trans,
                                         max_correspondence_distance=distance_threshold,
                                         max_iters=it)
        if stage == len(voxel_sizes) - 1:
            info = information_matrix(src_d, tgt_d, trans, max_correspondence_distance=v * 1.4)
    info = np.eye(6, dtype=np.float32) if info is None else info.cpu().numpy()
    return trans.cpu().numpy(), info


@dataclass
class MultiwayConfig:
    min_overlap: float = 0.30
    max_correspondence_distance: float = 0.07
    edge_prune_threshold: float = 0.25
    preference_loop_closure: float = 20.0
    icp_distance: float = 0.05 * 1.4


def _optimize(graph, cfg, dev):
    return optimize_pose_graph(graph, max_correspondence_distance=cfg.max_correspondence_distance,
                               edge_prune_threshold=cfg.edge_prune_threshold,
                               preference_loop_closure=cfg.preference_loop_closure, device=dev)


@full_f32_matmul()
def build_pose_graph(num_fragments: int, pairwise_results: dict, fragment_points: dict,
                     cfg: MultiwayConfig = MultiwayConfig(),
                     device: str | torch.device = "cuda") -> PoseGraph:
    """Assemble and optimize the pose graph of the pairwise registrations.

    Args:
        num_fragments: number of fragment nodes.
        pairwise_results: {(i, j): trans [4, 4]}, trans mapping fragment i's
            points into fragment j's frame, for every evaluated pair.
        fragment_points: {i: [N_i, 3]} points of each fragment (odometry ICP
            and the information matrices).

    Returns the optimized PoseGraph, node poses fragment -> world."""
    dev = resolve_device(device)
    # pose_j = pose_i @ inv(T_ij): T_ij maps src -> tgt frame
    poses = [np.eye(4)]
    edges = []
    for i in range(num_fragments - 1):
        j = i + 1
        trans = pairwise_results.get((i, j))
        if trans is None:
            trans = np.eye(4)
        trans, info = multi_scale_icp(fragment_points[i], fragment_points[j], trans,
                                      distance_threshold=cfg.icp_distance, device=dev)
        poses.append(poses[-1] @ np.linalg.inv(trans))
        edges.append(PoseGraphEdge(i, j, np.linalg.inv(trans), info, uncertain=False))

    for (i, j), trans in sorted(pairwise_results.items()):
        if j == i + 1:
            continue
        info = information_matrix(
            torch.as_tensor(np.asarray(fragment_points[i], np.float32), device=dev),
            torch.as_tensor(np.asarray(fragment_points[j], np.float32), device=dev),
            torch.as_tensor(np.asarray(trans, np.float32), device=dev),
            max_correspondence_distance=cfg.icp_distance).cpu().numpy()
        overlap = info[5, 5] / min(len(fragment_points[i]), len(fragment_points[j]))
        is_identity = abs(np.trace(trans) - 4.0) < 1e-9
        if overlap < cfg.min_overlap or is_identity:
            continue  # too little overlap: drop the loop closure
        edges.append(PoseGraphEdge(i, j, np.linalg.inv(trans), info, uncertain=True))

    return _optimize(PoseGraph(poses=poses, edges=edges), cfg, dev)


def refine_and_reoptimize(graph: PoseGraph, fragment_points: dict,
                          cfg: MultiwayConfig = MultiwayConfig(),
                          device: str | torch.device = "cuda") -> PoseGraph:
    """Second pass (test_multi_ate.py:183-227): ICP-refine every edge from the
    optimized relative poses, rebuild the informations, re-optimize."""
    dev = resolve_device(device)
    new_edges = []
    for e in graph.edges:
        rel = np.linalg.inv(np.asarray(graph.poses[e.source])) @ np.asarray(graph.poses[e.target])
        init = np.linalg.inv(rel)  # src -> tgt transform guess
        trans, info = multi_scale_icp(fragment_points[e.source], fragment_points[e.target], init,
                                      distance_threshold=cfg.icp_distance, device=dev)
        new_edges.append(PoseGraphEdge(e.source, e.target, np.linalg.inv(trans), info,
                                       uncertain=e.uncertain))
    return _optimize(PoseGraph(poses=list(graph.poses), edges=new_edges), cfg, dev)
