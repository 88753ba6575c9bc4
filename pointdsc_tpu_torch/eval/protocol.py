"""Benchmark stats protocol: the reference's 12-column per-pair matrix (the
port's copy of ``pointdsc_tpu/eval/protocol.py``, numpy only).

Mirrors the reference's evaluation/test_3DMatch.py:25-27,90-101,139-173:
  col 0  success (RE < re_thre and TE < te_thre)
  col 1  RE (deg)
  col 2  TE (cm)
  col 3  input inlier number
  col 4  input inlier ratio
  col 5  output inlier number
  col 6  output precision
  col 7  output recall
  col 8  output F1
  col 9  model_time (s)
  col 10 data_time (s)
  col 11 scene index

Scene- and pair-level aggregation averages RE/TE over *successful* pairs only
(test_3DMatch.py:146-151), exactly like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

STATS_COLUMNS = [
    "success",
    "re",
    "te",
    "input_inlier_num",
    "input_inlier_ratio",
    "output_inlier_num",
    "output_precision",
    "output_recall",
    "output_f1",
    "model_time",
    "data_time",
    "scene_ind",
]


@dataclass
class PairStats:
    row: np.ndarray  # [12]


def pair_stats(
    pred_trans: np.ndarray,  # [4, 4]
    pred_labels: np.ndarray,  # [N] 0/1
    gt_trans: np.ndarray,  # [4, 4]
    gt_labels: np.ndarray,  # [N]
    re_thre: float,
    te_thre: float,
    model_time: float,
    data_time: float,
    scene_ind: int,
    mask: np.ndarray | None = None,
) -> np.ndarray:
    """One 12-column stats row for a pair (all numpy, host side)."""
    if mask is not None:
        pred_labels = pred_labels[mask]
        gt_labels = gt_labels[mask]

    R_pred, t_pred = pred_trans[:3, :3], pred_trans[:3, 3]
    R_gt, t_gt = gt_trans[:3, :3], gt_trans[:3, 3]
    re = np.degrees(
        np.arccos(np.clip((np.trace(R_pred.T @ R_gt) - 1.0) / 2.0, -1.0, 1.0))
    )
    te = np.linalg.norm(t_pred - t_gt) * 100.0
    success = float(re < re_thre and te < te_thre)

    n = max(len(gt_labels), 1)
    input_num = float(gt_labels.sum())
    input_ratio = input_num / n

    pred_pos = pred_labels > 0
    gt_pos = gt_labels > 0
    tp = float(np.sum(pred_pos & gt_pos))
    # Column 5 counts gt inliers among predicted positives, i.e. true
    # positives — matching test_3DMatch.py:95 (sum(gt_labels[pred_labels>0])).
    output_num = tp
    precision = tp / max(float(np.sum(pred_pos)), 1.0)
    recall = tp / max(input_num, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)

    return np.array(
        [
            success,
            re,
            te,
            input_num,
            input_ratio,
            output_num,
            precision,
            recall,
            f1,
            model_time,
            data_time,
            float(scene_ind),
        ]
    )


def aggregate_stats(stats: np.ndarray, scene_names: list[str] | None = None):
    """Scene-level and pair-level aggregates (test_3DMatch.py:139-173).

    Args:
        stats: [num_pairs, 12].

    Returns dict with recall/re/te at pair level (RE/TE over successes only),
    per-scene rows, and timing means.
    """
    succ = stats[:, 0] > 0
    pair_recall = 100.0 * succ.mean() if len(stats) else 0.0
    re_succ = stats[succ, 1].mean() if succ.any() else 0.0
    te_succ = stats[succ, 2].mean() if succ.any() else 0.0

    scene_rows = []
    scene_inds = np.unique(stats[:, 11]).astype(int) if len(stats) else []
    for s in scene_inds:
        sel = stats[:, 11] == s
        ssucc = stats[sel, 0] > 0
        scene_rows.append(
            {
                "scene": scene_names[s] if scene_names else str(s),
                "recall": 100.0 * ssucc.mean(),
                "re": stats[sel][ssucc, 1].mean() if ssucc.any() else 0.0,
                "te": stats[sel][ssucc, 2].mean() if ssucc.any() else 0.0,
                "num_pairs": int(sel.sum()),
            }
        )

    return {
        "pair_recall": pair_recall,
        "re": re_succ,
        "te": te_succ,
        "input_inlier_ratio": stats[:, 4].mean() if len(stats) else 0.0,
        "output_precision": stats[:, 6].mean() if len(stats) else 0.0,
        "output_recall": stats[:, 7].mean() if len(stats) else 0.0,
        "output_f1": stats[:, 8].mean() if len(stats) else 0.0,
        "model_time": stats[:, 9].mean() if len(stats) else 0.0,
        "data_time": stats[:, 10].mean() if len(stats) else 0.0,
        "scenes": scene_rows,
    }


def format_scene_report(agg: dict) -> str:
    lines = []
    for row in agg["scenes"]:
        lines.append(
            f"Scene {row['scene']:>45s}: Recall={row['recall']:.2f}%, "
            f"RE={row['re']:.2f}, TE={row['te']:.2f} ({row['num_pairs']} pairs)"
        )
    lines.append(
        f"All {sum(r['num_pairs'] for r in agg['scenes'])} pairs: "
        f"Reg Recall={agg['pair_recall']:.2f}%, RE={agg['re']:.2f}, TE={agg['te']:.2f}"
    )
    lines.append(
        f"Input:  {agg['input_inlier_ratio']:.4f} inlier ratio | "
        f"Output: precision={agg['output_precision']:.4f}, "
        f"recall={agg['output_recall']:.4f}, f1={agg['output_f1']:.4f}"
    )
    note = agg.get("model_time_semantics")
    counters = agg.get("counters")  # the Evaluator's, where it ran the pairs
    lines.append(
        f"Avg model time: {agg['model_time']*1000:.2f}ms"
        + (f" [{note}]" if note else "")
        + f", data time: {agg['data_time']*1000:.2f}ms"
        + (f" | regime guard: probes={counters['probes']}, flips={counters['flips']}, "
           f"unprobed_offset_forwards={counters['unprobed_offset_forwards']}"
           if counters else "")
    )
    return "\n".join(lines)
