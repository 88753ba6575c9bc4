"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def expect(t: torch.Tensor, name: str, *, dtype=None, ndim=None, last=None,
           shape=None, device=None) -> None:
    """Raise ValueError unless t is a contiguous tensor of the given dtype,
    rank, last dimension, shape and device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"{name} must have last dim {last}, got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def expect_aligned(tensors: dict, nbytes: int = 16) -> None:
    """Raise ValueError unless every tensor of ``{name: tensor}`` starts on
    an nbytes boundary (a kernel that reads rows in 16-byte chunks)."""
    for name, t in tensors.items():
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name} must be {nbytes}-byte aligned")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# The channel chunk of the attention, encoder-layer, SM-loss and seed k-NN
# kernels. A model's width is zero-padded to the next multiple of it on the
# card (``padded_width``) and the result sliced back: a zero channel adds
# exact zeros to every dot product, norm and product, relu(0) = 0, and the
# padded gradient channels are zeros that are sliced off. The kernels are
# compiled for one chunk and walk the chunks of a wider model in turn.
C_KERNEL = 128


def padded_width(c: int) -> int:
    """The kernels' width for a C-wide model: C rounded up to a multiple of
    ``C_KERNEL``."""
    return C_KERNEL * max(1, -(-c // C_KERNEL))


def check_width(c: int, what: str) -> None:
    """Raise ValueError for a channel width the kernels cannot take (none
    below 1)."""
    if c < 1:
        raise ValueError(f"{what} take C >= 1, got C={c}")


def pad_channels(t: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """t [..., C] zero-padded to [..., width] (``padded_width(C)`` when None),
    contiguous (t itself when C is already ``width``)."""
    c = t.shape[-1]
    width = padded_width(c) if width is None else width
    if c == width:
        return t
    return torch.nn.functional.pad(t, (0, width - c))


def unpad_channels(t: torch.Tensor, c: int) -> torch.Tensor:
    """The first c channels of t [..., W], contiguous (t itself when W == c)."""
    return t if t.shape[-1] == c else t[..., :c].contiguous()
