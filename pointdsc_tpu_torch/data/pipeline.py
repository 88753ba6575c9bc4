"""Correspondences, input encodings, shape buckets and the batch loader (the
port's own copy of ``pointdsc_tpu/data/pipeline.py``: ``build_correspondences``,
``make_corr_pos``, ``bucket_size``, ``pad_to_bucket``, ``collate_batch``,
``Loader``), numpy and threads; the ``in_dim=12`` normals run in torch."""

from __future__ import annotations

import concurrent.futures as cf
import math
from typing import Iterator, Sequence

import numpy as np

from pointdsc_tpu_torch.data import transforms_np as T


def build_correspondences(src_keypts: np.ndarray, tgt_keypts: np.ndarray, src_desc: np.ndarray,
                          tgt_desc: np.ndarray, gt_trans: np.ndarray, inlier_threshold: float,
                          num_node: int | str = "all", use_mutual: bool = False, in_dim: int = 6,
                          rng: np.random.Generator | None = None, min_corr: int = 10,
                          sample_replace: bool | None = None, device: str = "cuda"):
    """Sample keypoints, NN-match descriptors, build labels and model input
    (reference ThreeDMatch.py:96-174). The ``rng.choice`` calls are the JAX
    package's, in its order, so a seeded generator samples the same
    keypoints. ``device`` is where the ``in_dim=12`` normals are estimated.

    Returns dict with corr_pos [N, in_dim], src/tgt keypts [N, 3],
    gt_trans [4, 4], gt_labels [N]."""
    rng = rng or np.random.default_rng()

    n_src, n_tgt = src_desc.shape[0], tgt_desc.shape[0]
    if num_node == "all":
        src_sel = np.arange(n_src)
        tgt_sel = np.arange(n_tgt)
    else:
        # sample_replace=True is the reference 3DMatch path's np.random.choice
        # default (duplicates possible); False is KITTI's / Redwood's; None
        # replaces only when the cloud is too small
        k = int(num_node)
        rep_src = sample_replace if sample_replace is not None else n_src < k
        rep_tgt = sample_replace if sample_replace is not None else n_tgt < k
        src_sel = rng.choice(n_src, k, replace=rep_src or n_src < k)
        tgt_sel = rng.choice(n_tgt, k, replace=rep_tgt or n_tgt < k)
    src_desc, tgt_desc = src_desc[src_sel], tgt_desc[tgt_sel]
    src_keypts, tgt_keypts = src_keypts[src_sel], tgt_keypts[tgt_sel]

    # NN matching in descriptor space: sqrt(2 - 2 cos) falls as the inner
    # product rises, so the argmax of the inner product is the nearest
    inner = src_desc @ tgt_desc.T
    source_idx = np.argmax(inner, axis=1)
    if use_mutual:
        target_idx = np.argmax(inner, axis=0)
        mutual = target_idx[source_idx] == np.arange(source_idx.shape[0])
        corr = np.stack([np.nonzero(mutual)[0], source_idx[mutual]], axis=-1)
        if len(corr) < min_corr:  # degenerate pair: fall back to all matches
            corr = np.stack([np.arange(len(source_idx)), source_idx], axis=-1)
    else:
        corr = np.stack([np.arange(len(source_idx)), source_idx], axis=-1)

    input_src = src_keypts[corr[:, 0]]
    input_tgt = tgt_keypts[corr[:, 1]]

    warped = T.transform(input_src, gt_trans)
    distance = np.linalg.norm(warped - input_tgt, axis=-1)
    labels = (distance < inlier_threshold).astype(np.float32)

    if in_dim == 12:
        # normals of the sampled keypoint clouds, radius 2 x the default 0.03
        # downsample (reference ThreeDMatch.py:157-168)
        corr_pos = _normals_corr_pos(src_keypts, tgt_keypts, corr, normal_radius=0.06,
                                     device=device)
    else:
        corr_pos = make_corr_pos(input_src, input_tgt, in_dim,
                                 src_desc[corr[:, 0]], tgt_desc[corr[:, 1]])
    return {
        "corr_pos": corr_pos.astype(np.float32),
        "src_keypts": input_src.astype(np.float32),
        "tgt_keypts": input_tgt.astype(np.float32),
        "gt_trans": gt_trans.astype(np.float32),
        "gt_labels": labels,
    }


def _normals_corr_pos(src_keypts, tgt_keypts, corr, normal_radius=0.06, device="cuda"):
    """in_dim=12 encoding: [src, src_normal, tgt, tgt_normal]."""
    import torch

    from pointdsc_tpu_torch._device import resolve_device
    from pointdsc_tpu_torch.descriptors.fpfh import estimate_normals

    dev = resolve_device(device)
    src_n, tgt_n = (
        estimate_normals(torch.as_tensor(np.asarray(k, np.float32), device=dev),
                         normal_radius).cpu().numpy()
        for k in (src_keypts, tgt_keypts))
    return np.concatenate(
        [src_keypts[corr[:, 0]], src_n[corr[:, 0]], tgt_keypts[corr[:, 1]], tgt_n[corr[:, 1]]],
        axis=-1)


def make_corr_pos(input_src, input_tgt, in_dim, src_desc=None, tgt_desc=None):
    """Input encodings (reference ThreeDMatch.py:144-168)."""
    if in_dim == 3:
        return input_src - input_tgt
    if in_dim == 6:
        corr_pos = np.concatenate([input_src, input_tgt], axis=-1)
        return corr_pos - corr_pos.mean(0)
    if in_dim == 9:
        return np.concatenate(
            [input_src, input_tgt, input_src - input_tgt], axis=-1
        )
    if in_dim == 70:
        corr_pos = np.concatenate([input_src, input_tgt], axis=-1)
        corr_pos = corr_pos - corr_pos.mean(0)
        return np.concatenate([corr_pos, src_desc, tgt_desc], axis=-1)
    raise ValueError(f"unsupported in_dim {in_dim}")


# Bucket sizes are multiples of 256, so the kernels' 32-row and 64-key tiles
# always divide N evenly.
_BUCKETS = (256, 512, 1024, 2048, 4096, 5120, 6144, 8192, 12288, 16384, 20480, 24576)


def bucket_size(n: int, buckets: Sequence[int] = _BUCKETS) -> int:
    """Smallest bucket >= n (one warm-up and one regime probe per bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / 2048) * 2048)


def pad_to_bucket(sample: dict, n_pad: int | None = None) -> dict:
    """Pad per-correspondence arrays to the bucket size; attach 'mask'."""
    n = sample["corr_pos"].shape[0]
    n_pad = n_pad or bucket_size(n)
    out = dict(sample)
    pad = n_pad - n

    def padded(a):
        if pad == 0:
            return a
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)

    for key in ("corr_pos", "src_keypts", "tgt_keypts", "gt_labels"):
        out[key] = padded(sample[key])
    out["mask"] = np.arange(n_pad) < n
    return out


def collate_batch(samples: list[dict]) -> dict:
    """Stack padded samples; all must share the same bucket."""
    n_pad = max(s["corr_pos"].shape[0] for s in samples)
    n_pad = bucket_size(n_pad)
    padded = [pad_to_bucket(s, n_pad) for s in samples]
    return {
        k: np.stack([s[k] for s in padded], axis=0) for k in padded[0].keys()
    }


class Loader:
    """Minimal prefetching loader: dataset[i] -> sample dict, batched and
    padded to a bucket with a mask. A thread pool builds up to four batches
    ahead (the samples' numpy work releases the interpreter lock).
    ``drop_last`` gives ``len(dataset) // batch_size`` iterations, as the
    reference's loop runs."""

    PREFETCH = 4

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, num_workers: int = 8,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)

        def fetch(batch_idx):
            idxs = order[batch_idx * self.batch_size:(batch_idx + 1) * self.batch_size]
            return collate_batch([self.dataset[int(i)] for i in idxs])

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending = [pool.submit(fetch, b) for b in range(min(self.PREFETCH, n_batches))]
            for b in range(n_batches):
                nxt = b + self.PREFETCH
                if nxt < n_batches:
                    pending.append(pool.submit(fetch, nxt))
                yield pending.pop(0).result()
