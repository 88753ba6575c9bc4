"""Point-cloud descriptors (PyTorch counterpart of ``pointdsc_tpu/descriptors``):
FPFH. The FCGF network is not ported."""

from pointdsc_tpu_torch.descriptors.fpfh import (
    estimate_normals,
    extract_fpfh,
    fpfh_features,
    voxel_downsample,
)

__all__ = ["estimate_normals", "extract_fpfh", "fpfh_features", "voxel_downsample"]
