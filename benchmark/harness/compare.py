"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs, each
held to a limit of the cell's own (``benchmark/limits/<workload>.json``).

Eval (per compared pair; a run reports the worst pair, and of conf_rms
also the median pair):
  conf_rms    RMS over the valid points of |c - c_ref| over the spread
              (standard deviation) of c_ref, c the confidence logits: the
              cache, the encoder and the head (conf_gap: the max;
              conf_rms_median: the median over the compared pairs, steady
              where the worst pair swings with the rounding of the
              attention's logits on pairs of many inliers);
  pose_gap    max over the valid source points of |T x - T_ref x|, over the
              inlier threshold: the final transform (seeds, hypotheses,
              selection, post-refinement);
  label_gap   share of valid points whose inlier label differs.

Which of them a cell holds, and to what, is its limits file's choice.
"""

from __future__ import annotations

import numpy as np


def registered(trans: np.ndarray, gt: np.ndarray, re_thre: float, te_thre: float) -> bool:
    """The reference protocol's success: rotation error under ``re_thre``
    degrees and translation error under ``te_thre`` centimetres."""
    r = np.clip((np.trace(trans[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return bool(np.degrees(np.arccos(r)) < re_thre
                and np.linalg.norm(trans[:3, 3] - gt[:3, 3]) * 100.0 < te_thre)


def eval_pair(prog: dict, ref: dict, sample: dict, inlier_threshold: float) -> dict:
    src = sample["src_keypts"].astype(np.float64)
    tp, tr = prog["trans"].astype(np.float64), ref["trans"].astype(np.float64)
    moved = (src @ tp[:3, :3].T + tp[:3, 3]) - (src @ tr[:3, :3].T + tr[:3, 3])
    cr = ref["confidence"].astype(np.float64)
    rel = np.abs(prog["confidence"] - cr) / max(np.std(cr), 1e-12)
    return {
        "conf_gap": float(np.max(rel)),
        "conf_rms": float(np.sqrt(np.mean(rel * rel))),
        "pose_gap": float(np.max(np.linalg.norm(moved, axis=-1)) / inlier_threshold),
        "label_gap": float(np.mean((prog["labels"] > 0) != (ref["labels"] > 0))),
    }


def held(numbers: dict, limits: dict) -> dict:
    """{name: (value, limit, within)} of every number the cell holds to a
    limit."""
    return {k: (numbers[k], lim["limit"], numbers[k] <= lim["limit"])
            for k, lim in limits.items() if k in numbers}
