"""Point-cloud descriptors (PyTorch counterpart of ``pointdsc_tpu/descriptors``):
FPFH and the VoxelFCGF network with its hardest-contrastive training."""

from pointdsc_tpu_torch.descriptors.fcgf import (
    VoxelFCGF,
    extract_features,
    extract_features_tiled,
    load_fcgf,
    voxelize,
)
from pointdsc_tpu_torch.descriptors.fcgf_train import (
    hardest_contrastive_loss,
    make_fcgf_train_step,
)
from pointdsc_tpu_torch.descriptors.fpfh import (
    estimate_normals,
    extract_fpfh,
    fpfh_features,
    voxel_downsample,
)

__all__ = ["VoxelFCGF", "estimate_normals", "extract_features", "extract_features_tiled",
           "extract_fpfh", "fpfh_features", "hardest_contrastive_loss", "load_fcgf",
           "make_fcgf_train_step", "voxel_downsample", "voxelize"]
