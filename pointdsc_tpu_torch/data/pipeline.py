"""Input encodings, shape buckets and the batch loader (the port's own copy
of ``pointdsc_tpu/data/pipeline.py``: ``make_corr_pos``, ``bucket_size``,
``pad_to_bucket``, ``collate_batch``, ``Loader``), numpy and threads only."""

from __future__ import annotations

import concurrent.futures as cf
import math
from typing import Iterator, Sequence

import numpy as np


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
