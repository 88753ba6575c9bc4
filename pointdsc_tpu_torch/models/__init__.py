from pointdsc_tpu_torch.models.pointdsc import PointDSC, PointDSCOutput

__all__ = ["PointDSC", "PointDSCOutput"]
