"""Device resolution and float32 matmul precision for the port's entry points.

Every entry point takes an explicit ``device`` whose default is ``"cuda"``.
When CUDA is missing and the caller did not ask for the CPU, it raises: the
port never drops to the CPU quietly.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 (TF32 off for cuBLAS and
    cuDNN) inside the block, and restore the caller's flags after it. The
    plain versions of the kernels are the kernels' references, and TF32's
    ~3 significant digits would break the 1e-4 parity tolerances against
    them and against the JAX package. Also a decorator."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
