from pointdsc_tpu_torch.data.pipeline import make_corr_pos
from pointdsc_tpu_torch.data.synthetic import SyntheticPairDataset

__all__ = ["SyntheticPairDataset", "make_corr_pos"]
