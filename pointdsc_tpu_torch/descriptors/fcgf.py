"""FCGF-style learned descriptor: a dense-voxel 3-D ResUNet (PyTorch
counterpart of ``pointdsc_tpu/descriptors/fcgf.py``).

Points are voxelized to a dense occupancy grid, run through a 4-down/4-up
ResUNet with skip connections (encoder channels (32, 64, 128, 256), decoder
(128, 128, 96, 96), a final 1x1 to 32), and each occupied voxel's
descriptor is gathered and L2-normalised. Outdoor clouds (KITTI at 30 cm
over ~100 m) run in overlapping tiles of the same grid.

Tensors are NCDHW. The module tree carries the flax names (``ConvBlock_0``,
``ResBlock_3.Conv_2``, ``ConvTranspose_1``, ...), so that a flax checkpoint
maps onto the state dict key by key (compat/fcgf_weights.py). Three places
where flax and ``torch.nn.functional`` differ are written out here:

* a stride-2 ``SAME`` convolution pads (0, 1) on an even size (flax's rule,
  ``_same_pads``), not the (1, 1) of ``padding=1``;
* flax's ``ConvTranspose(stride=2, padding="SAME")`` is a convolution of the
  stride-dilated input padded (2, 1) with the kernel as stored: the port
  keeps the kernel flipped on its three spatial axes (the weight map flips
  it), runs ``conv_transpose3d`` without padding and crops the output to
  twice the input;
* a BatchNorm in training mode normalises with the biased batch variance
  E[x^2] - E[x]^2 (clipped at 0, flax's fast form) and stores that same
  variance in its running statistics with momentum 0.9.

The convolutions run in full float32 (``full_f32_matmul``: cuDNN's TF32
would leave the CPU's and the reference's results by ~1e-3).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pointdsc_tpu_torch._device import full_f32_matmul, resolve_device


def voxelize(points: np.ndarray, voxel_size: float, grid_size: int,
             origin: np.ndarray | None = None):
    """Quantize points to a dense grid: (occupancy [1, D, D, D] float32,
    indices [N, 3] int32 clipped to the grid, origin [3] float64). Points
    outside the grid are clamped to its border (large clouds are tiled)."""
    pts = np.asarray(points, np.float64)
    origin = pts.min(0) if origin is None else np.asarray(origin, np.float64)
    idx = np.floor((pts - origin) / voxel_size).astype(np.int32)
    idx = np.clip(idx, 0, grid_size - 1)
    occ = np.zeros((1, grid_size, grid_size, grid_size), np.float32)
    occ[0, idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
    return occ, idx, origin


def take_voxels(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[C, D, D, D] features at voxel indices [M, 3] -> [M, C]. An index
    outside the grid reads as the reference's gather reads it: a negative
    one counts from the end, then each is clamped to [0, D - 1]; a row read
    from outside the grid carries no gradient (the gather's transpose there
    drops its out-of-bounds updates)."""
    size = torch.tensor(grid.shape[1:], device=grid.device)
    idx = idx.to(grid.device).long()
    idx = torch.where(idx < 0, idx + size, idx)
    inside = torch.all((idx >= 0) & (idx < size), dim=1)
    idx = torch.minimum(torch.clamp(idx, min=0), size - 1)
    feats = grid[:, idx[:, 0], idx[:, 1], idx[:, 2]].T
    return torch.where(inside[:, None], feats, feats.detach())


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax's ``padding="SAME"`` on one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with ``padding=0``) with flax's ``SAME`` padding."""
    k, s = conv.kernel_size[0], conv.stride[0]
    pads = [p for n in reversed(x.shape[2:]) for p in _same_pads(n, k, s)]
    if len(set(pads)) == 1:
        return F.conv3d(x, conv.weight, conv.bias, s, pads[0])
    return F.conv3d(F.pad(x, pads), conv.weight, conv.bias, s)


def conv_transpose_same(conv: nn.ConvTranspose3d, x: torch.Tensor) -> torch.Tensor:
    """flax's ``ConvTranspose(stride=2, padding="SAME")`` for a 3^3 kernel
    kept flipped in ``conv`` (``padding=0``): the first 2n of the 2n + 1
    outputs on each axis."""
    d, h, w = (2 * n for n in x.shape[2:])
    return F.conv_transpose3d(x, conv.weight, conv.bias, stride=2)[..., :d, :h, :w]


class VoxelBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the batch and the three
    spatial axes of an NCDHW tensor, eps 1e-5 (see the module docstring)."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = (0, 2, 3, 4)
            mean = torch.mean(x, dim=dims)
            var = torch.maximum(torch.mean(x * x, dim=dims) - mean * mean,
                                torch.zeros((), dtype=x.dtype, device=x.device))
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1, 1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


class ConvBlock(nn.Module):
    """3^3 convolution (stride 1 or 2, ``SAME``) + BatchNorm + ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv3d(in_features, features, 3, stride=stride)
        self.BatchNorm_0 = VoxelBatchNorm(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(conv_same(self.Conv_0, x)))


class ResBlock(nn.Module):
    """Two 3^3 conv + BatchNorm, a 1^3 projection of the input where the
    width changes, residual ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv3d(in_features, features, 3)
        self.BatchNorm_0 = VoxelBatchNorm(features)
        self.Conv_1 = nn.Conv3d(features, features, 3)
        self.BatchNorm_1 = VoxelBatchNorm(features)
        self.Conv_2 = nn.Conv3d(in_features, features, 1) if in_features != features else None

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(conv_same(self.Conv_0, x)))
        h = self.BatchNorm_1(conv_same(self.Conv_1, h))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(x + h)


class VoxelFCGF(nn.Module):
    """Dense-voxel ResUNet descriptor network.

    Input: occupancy [B, 1, D, D, D]; output: features [B, out_dim, D, D, D],
    L2-normalised per voxel (``normalize``). ``module.training`` is the
    reference's ``train``. Random weights come from ``generator``; trained
    ones from ``load_fcgf`` / compat/fcgf_weights.py."""

    def __init__(self, out_dim: int = 32, enc_channels=(32, 64, 128, 256),
                 dec_channels=(128, 128, 96, 96), normalize: bool = True,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.out_dim = out_dim
        self.enc_channels = tuple(enc_channels)
        self.dec_channels = tuple(dec_channels)
        self.normalize = normalize
        enc, dec = self.enc_channels, self.dec_channels
        self.ConvBlock_0 = ConvBlock(1, enc[0])
        width = enc[0]
        for i, ch in enumerate(enc):
            setattr(self, f"ResBlock_{i}", ResBlock(width, ch))
            setattr(self, f"ConvBlock_{i + 1}", ConvBlock(ch, ch, stride=2))
            width = ch
        setattr(self, f"ResBlock_{len(enc)}", ResBlock(width, width))
        for j, (ch, skip) in enumerate(zip(dec, reversed(enc))):
            setattr(self, f"ConvTranspose_{j}", nn.ConvTranspose3d(width, ch, 3, stride=2))
            setattr(self, f"BatchNorm_{j}", VoxelBatchNorm(ch))
            setattr(self, f"ResBlock_{len(enc) + 1 + j}", ResBlock(ch + skip, ch))
            width = ch
        self.Conv_0 = nn.Conv3d(width, out_dim, 1)
        if generator is not None:
            self._init_random(generator)
        self.to(dev).eval()

    @torch.no_grad()
    def _init_random(self, generator: torch.Generator) -> None:
        """Kernels normal with variance 1 / fan_in (flax's LeCun scale, not
        its truncated draw), zero biases, from the caller's generator."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
                w = mod.weight
                fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose3d) else w.shape[1]) \
                    * w[0, 0].numel()
                w.copy_(torch.randn(w.shape, generator=generator) / fan_in ** 0.5)
                mod.bias.zero_()

    @full_f32_matmul()
    def forward(self, occ: torch.Tensor) -> torch.Tensor:
        n = len(self.enc_channels)
        x = self.ConvBlock_0(occ)
        skips = []
        for i in range(n):
            x = getattr(self, f"ResBlock_{i}")(x)
            skips.append(x)
            x = getattr(self, f"ConvBlock_{i + 1}")(x)
        x = getattr(self, f"ResBlock_{n}")(x)
        for j, skip in enumerate(reversed(skips)):
            x = conv_transpose_same(getattr(self, f"ConvTranspose_{j}"), x)
            x = F.relu(getattr(self, f"BatchNorm_{j}")(x))
            x = getattr(self, f"ResBlock_{n + 1 + j}")(torch.cat([x, skip], dim=1))
        x = self.Conv_0(x)
        if self.normalize:
            x = x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-12)
        return x


@contextlib.contextmanager
def _inference(model: nn.Module):
    """Eval mode and no autograd inside the block; the caller's mode after."""
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield next(model.parameters()).device
    finally:
        model.train(was)


def extract_features(model: VoxelFCGF, points: np.ndarray, voxel_size: float = 0.05,
                     grid_size: int = 96, origin: np.ndarray | None = None):
    """Per-voxel descriptors of one cloud on the model's device: (keypts
    [M, 3] float32 voxel centres, features [M, out_dim] float32), numpy, the
    voxels in ``np.unique`` order (the loaders pair rows by index)."""
    occ, idx, origin = voxelize(points, voxel_size, grid_size, origin=origin)
    uniq = np.unique(idx, axis=0)
    with _inference(model) as dev:
        grid = model(torch.from_numpy(occ)[None].to(dev))[0]
        feats = take_voxels(grid, torch.from_numpy(uniq)).cpu().numpy()
    keypts = (uniq.astype(np.float64) + 0.5) * voxel_size + origin
    return keypts.astype(np.float32), feats


def extract_features_tiled(model: VoxelFCGF, points: np.ndarray, voxel_size: float = 0.30,
                           grid_size: int = 96, halo: int = 8, tile_batch: int = 4):
    """Outdoor-scale extraction: the cloud in overlapping tiles of
    ``grid_size`` voxels, each point's descriptor from the tile whose
    interior holds it (the ``halo`` border absorbs the convolutions' edge
    effects); ``tile_batch`` tiles a forward. Returns (keypts [M, 3],
    features [M, out_dim]) over all occupied voxels."""
    pts = np.asarray(points, np.float64)
    origin = pts.min(0)
    extent = int(grid_size - 2 * halo)
    tile_idx = np.floor((pts - origin) / (voxel_size * extent)).astype(np.int64)

    tiles = []  # (occ, uniq_idx, tile_origin, tile_coord)
    for t in np.unique(tile_idx, axis=0):
        tile_origin = origin + t * voxel_size * extent - halo * voxel_size
        local = pts - tile_origin
        inside = np.all((local >= 0) & (local < grid_size * voxel_size), axis=1)
        interior = np.all(tile_idx == t, axis=1)
        sel = pts[inside | interior]
        if len(sel) == 0:
            continue
        occ, idx, _ = voxelize(sel - tile_origin, voxel_size, grid_size, origin=np.zeros(3))
        tiles.append((occ, np.unique(idx, axis=0), tile_origin, t))
    if not tiles:
        return np.zeros((0, 3), np.float32), np.zeros((0, model.out_dim), np.float32)

    all_k, all_f = [], []
    with _inference(model) as dev:
        for lo in range(0, len(tiles), tile_batch):
            chunk = tiles[lo:lo + tile_batch]
            grids = model(torch.from_numpy(np.stack([c[0] for c in chunk])).to(dev))
            for (_, uniq, tile_origin, t), grid in zip(chunk, grids):
                feats = take_voxels(grid, torch.from_numpy(uniq)).cpu().numpy()
                keypts = (uniq.astype(np.float64) + 0.5) * voxel_size + tile_origin
                # only interior voxels: no duplicates across tiles
                rel = (keypts - (origin + t * voxel_size * extent)) / (voxel_size * extent)
                keep = np.all((rel >= 0) & (rel < 1.0), axis=1)
                all_k.append(keypts[keep].astype(np.float32))
                all_f.append(feats[keep])
    return np.concatenate(all_k), np.concatenate(all_f)


def load_fcgf(checkpoint: str | None, out_dim: int = 32, channels=None,
              device: str | torch.device = "cuda") -> VoxelFCGF:
    """The VoxelFCGF model with a flax checkpoint's weights (the reference's
    ``serialization.to_bytes`` file, e.g. ``snapshot/fcgf_synth_release.pkl``),
    or seeded random weights when ``checkpoint`` is empty. ``channels`` sets
    the encoder widths."""
    from pointdsc_tpu_torch.compat.fcgf_weights import load_fcgf_state_dict

    dev = resolve_device(device)
    kwargs = {"out_dim": out_dim}
    if channels is not None:
        kwargs["enc_channels"] = tuple(channels)
    if checkpoint:
        model = VoxelFCGF(**kwargs, device="cpu")
        model.load_state_dict(load_fcgf_state_dict(checkpoint))
        print(f"loaded VoxelFCGF weights from {checkpoint}")
    else:
        model = VoxelFCGF(**kwargs, device="cpu", generator=torch.Generator().manual_seed(0))
        print("WARNING: no --checkpoint given; extracting with RANDOM "
              "weights (pipeline smoke tests only, descriptors are useless)")
    return model.to(dev)
