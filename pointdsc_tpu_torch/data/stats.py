"""Dataset statistics: inlier-ratio histograms per split (the port's own
copy of ``pointdsc_tpu/data/stats.py``; the reference's datasets/stats.py)."""

from __future__ import annotations

import numpy as np


def process_split(dataset, num_samples: int | None = None, bins: int = 20):
    """Histogram the per-pair inlier ratios of the first ``num_samples`` pairs
    (all by default). Returns {'ratios' [n], 'hist' [bins], 'edges'
    [bins + 1], 'mean', 'median'}."""
    n = len(dataset) if num_samples is None else min(num_samples, len(dataset))
    ratios = np.zeros(n)
    for i in range(n):
        labels = dataset[i]["gt_labels"]
        ratios[i] = float(labels.mean()) if len(labels) else 0.0
    hist, edges = np.histogram(ratios, bins=bins, range=(0.0, 1.0))
    return {"ratios": ratios, "hist": hist, "edges": edges, "mean": float(ratios.mean()),
            "median": float(np.median(ratios))}


def print_split_report(name: str, stats: dict) -> None:
    print(f"Split {name}: {len(stats['ratios'])} pairs, "
          f"mean inlier ratio {stats['mean']:.3f}, median {stats['median']:.3f}")
    for lo, hi, c in zip(stats["edges"][:-1], stats["edges"][1:], stats["hist"]):
        bar = "#" * int(50 * c / max(stats["hist"].max(), 1))
        print(f"  [{lo:.2f},{hi:.2f}) {c:5d} {bar}")
