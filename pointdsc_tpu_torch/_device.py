"""Device resolution and float32 matmul precision for the port's entry points.

Every entry point takes an explicit ``device`` whose default is ``"cuda"``.
When CUDA is missing and the caller did not ask for the CPU, it raises: the
port never drops to the CPU quietly.
"""

from __future__ import annotations

import contextlib
import threading

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


# The TF32 flags are global to the process, and the data loader's threads
# enter the block (the in_dim=12 normals) while the main thread runs a
# forward in it: the flags are saved by the first thread to enter and
# restored by the last to leave.
_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved = (False, False)


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 (TF32 off for cuBLAS and
    cuDNN) inside the block, and restore the caller's flags once no thread
    is inside one. The plain versions of the kernels are the kernels'
    references, and TF32's ~3 significant digits would break the 1e-4
    parity tolerances against them and against the JAX package. Also a
    decorator."""
    global _tf32_depth, _tf32_saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (matmul.allow_tf32, cudnn.allow_tf32)
            matmul.allow_tf32 = False
            cudnn.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                matmul.allow_tf32, cudnn.allow_tf32 = _tf32_saved
