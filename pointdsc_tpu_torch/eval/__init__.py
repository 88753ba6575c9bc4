"""Pair-wise evaluation: the Evaluator, the 12-column stats protocol and the
auxiliary metrics."""

from pointdsc_tpu_torch.eval.metrics import exact_auc, rot_to_euler
from pointdsc_tpu_torch.eval.protocol import STATS_COLUMNS, aggregate_stats, pair_stats
from pointdsc_tpu_torch.eval.runner import Evaluator

__all__ = ["Evaluator", "STATS_COLUMNS", "aggregate_stats", "pair_stats", "exact_auc",
           "rot_to_euler"]
