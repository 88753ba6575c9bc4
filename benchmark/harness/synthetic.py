"""Synthetic registration pairs for the benchmark's traffic: a frozen copy of
the program's generator (``pointdsc_tpu_torch/data/synthetic.py`` with
``data/transforms_np.py`` and ``data/pipeline.py::make_corr_pos``), so that
a change to the program cannot move the yardstick.

A pair is a random rigid motion (rotation angles up to 2 pi about each
axis, translation up to 0.5 in each coordinate) of points uniform in a cube
of half-width ``scene_scale``, Gaussian noise on the target, and a share
``1 - inlier_ratio`` of the targets replaced by uniform outliers. Labels are
``|T src - tgt| < inlier_threshold``.

``pool_plan`` gives every seed the same set of sizes and inlier ratios, in
an order drawn from the seed; only the geometry of each pair depends on the
seed, so the work of a pool does not.
"""

from __future__ import annotations

import numpy as np


def _rotation(rng: np.random.Generator) -> np.ndarray:
    angles = rng.random(3) * 2.0 * np.pi
    c, s = np.cos(angles), np.sin(angles)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    return rx @ ry @ rz


def make_pair(rng: np.random.Generator, n: int, inlier_ratio: float, noise: float,
              scene_scale: float, inlier_threshold: float) -> dict:
    """One pair of n correspondences (float32 arrays, ``in_dim`` 6)."""
    trans = np.eye(4)
    trans[:3, :3] = _rotation(rng)
    trans[:3, 3] = rng.random(3) * 0.5
    src = rng.uniform(-scene_scale, scene_scale, size=(n, 3))
    warped = src @ trans[:3, :3].T + trans[:3, 3]
    tgt = warped + rng.normal(size=(n, 3)) * noise
    n_out = int(n * (1.0 - inlier_ratio))
    out_idx = rng.choice(n, n_out, replace=False)
    tgt[out_idx] = rng.uniform(-scene_scale, scene_scale, size=(n_out, 3))
    labels = (np.linalg.norm(warped - tgt, axis=-1) < inlier_threshold).astype(np.float32)
    corr_pos = np.concatenate([src, tgt], axis=-1)
    corr_pos = corr_pos - corr_pos.mean(0)
    return {"corr_pos": corr_pos.astype(np.float32), "src_keypts": src.astype(np.float32),
            "tgt_keypts": tgt.astype(np.float32), "gt_trans": trans.astype(np.float32),
            "gt_labels": labels}


def pool_plan(count: int, n_range, ratio_range, seed: int) -> list[tuple[int, float]]:
    """(n, inlier ratio) of each pair of a pool of ``count``: n evenly spread
    over ``n_range`` (inclusive), the ratios evenly spread over
    ``ratio_range`` and paired with the sizes by a fixed stride, the whole
    set permuted by the seed."""
    lo, hi = n_range
    rlo, rhi = ratio_range
    stride = _coprime_stride(count)
    plan = []
    for i in range(count):
        f = (i + 0.5) / count
        g = (((i * stride) % count) + 0.5) / count
        plan.append((int(round(lo + f * (hi - lo))), float(rlo + g * (rhi - rlo))))
    rng = np.random.default_rng([seed, 0])
    return [plan[i] for i in rng.permutation(count)]


def _coprime_stride(count: int) -> int:
    """A stride near count / golden ratio that is coprime to count (1 for
    a count of 1 or 2)."""
    s = max(1, int(round(count * 0.6180339887)))
    while np.gcd(s, count) != 1:
        s += 1
    return s


def make_pool(traffic: dict, seed: int, count: int | None = None) -> list[dict]:
    """The pairs of a traffic mix, in pool order: pair i from the generator
    seeded (seed, 1, i)."""
    count = count or traffic["pool"]
    plan = pool_plan(count, traffic["n_range"], traffic["inlier_ratio"], seed)
    return [make_pair(np.random.default_rng([seed, 1, i]), n, r, traffic["noise"],
                      traffic["scene_scale"], traffic["inlier_threshold"])
            for i, (n, r) in enumerate(plan)]


def pad(sample: dict, bucket: int) -> dict:
    """The pair padded to ``bucket`` rows with zeros, plus its ``mask``."""
    n = sample["corr_pos"].shape[0]
    out = dict(sample)
    for key in ("corr_pos", "src_keypts", "tgt_keypts", "gt_labels"):
        a = sample[key]
        out[key] = np.concatenate([a, np.zeros((bucket - n,) + a.shape[1:], a.dtype)])
    out["mask"] = np.arange(bucket) < n
    return out
