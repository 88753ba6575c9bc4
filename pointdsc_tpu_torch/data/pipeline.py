"""Input encodings (the port's own copy of
``pointdsc_tpu/data/pipeline.py::make_corr_pos``)."""

from __future__ import annotations

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
