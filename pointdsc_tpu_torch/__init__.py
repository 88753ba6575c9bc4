"""PointDSC on PyTorch and CUDA (H100), beside the JAX package.

The eval forward, the training path, the registration path (FPFH,
matching, ICP, ``tools/demo_registration.py``), the dataset loaders and CLIs,
the classical baselines, and multiway registration with RGB-D fragment fusion
(``multiway/``, ``fusion/``) of ``pointdsc_tpu`` with their
TPU kernels rewritten as hand-written CUDA kernels for sm_90a (``kernels/csrc``). Imports torch and
numpy only. Entry points take ``device`` (default ``"cuda"``) and raise
when CUDA is missing unless the caller asked for ``"cpu"``.
"""

from pointdsc_tpu_torch.api import load_pretrained, register
from pointdsc_tpu_torch.eval.runner import Evaluator
from pointdsc_tpu_torch.models.pointdsc import PointDSC, PointDSCOutput
from pointdsc_tpu_torch.train.trainer import Trainer

__all__ = ["Evaluator", "PointDSC", "PointDSCOutput", "Trainer", "load_pretrained", "register"]
