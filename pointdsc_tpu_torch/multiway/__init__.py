"""Multiway registration: the pose graph, multi-scale ICP, the ATE, and the
three Redwood CLIs (``make_fragments``, ``test_multi``, ``test_multi_ate``)."""

from pointdsc_tpu_torch.multiway.ate import align_trajectories, ate_rmse
from pointdsc_tpu_torch.multiway.pose_graph import PoseGraph, PoseGraphEdge, optimize_pose_graph

__all__ = ["PoseGraph", "PoseGraphEdge", "align_trajectories", "ate_rmse",
           "optimize_pose_graph"]
