"""PointDSC on PyTorch and CUDA (H100), beside the JAX package.

The eval forward of ``pointdsc_tpu`` with its TPU kernels rewritten as
hand-written CUDA kernels for sm_90a (``kernels/csrc``). Imports torch and
numpy only. Entry points take ``device`` (default ``"cuda"``) and raise
when CUDA is missing unless the caller asked for ``"cpu"``.
"""

from pointdsc_tpu_torch.api import load_pretrained, register
from pointdsc_tpu_torch.eval.runner import Evaluator
from pointdsc_tpu_torch.models.pointdsc import PointDSC, PointDSCOutput

__all__ = ["Evaluator", "PointDSC", "PointDSCOutput", "load_pretrained", "register"]
