from pointdsc_tpu_torch.data.pipeline import (
    bucket_size,
    collate_batch,
    make_corr_pos,
    pad_to_bucket,
)
from pointdsc_tpu_torch.data.synthetic import SyntheticPairDataset

__all__ = ["SyntheticPairDataset", "bucket_size", "collate_batch", "make_corr_pos",
           "pad_to_bucket"]
