"""RGB-D fusion: the camera model, depth and RGB-D odometry, the TSDF volume
and the fragments (counterparts of ``pointdsc_tpu/fusion``)."""

from pointdsc_tpu_torch.fusion.camera import PinholeIntrinsics, backproject_depth
from pointdsc_tpu_torch.fusion.odometry import depth_odometry, rgbd_odometry
from pointdsc_tpu_torch.fusion.tsdf import TSDFVolume, extract_surface_points

__all__ = ["PinholeIntrinsics", "TSDFVolume", "backproject_depth", "depth_odometry",
           "extract_surface_points", "rgbd_odometry"]
