from pointdsc_tpu_torch.models.oanet import OANet
from pointdsc_tpu_torch.models.pointdsc import PointDSC, PointDSCOutput

__all__ = ["OANet", "PointDSC", "PointDSCOutput"]
