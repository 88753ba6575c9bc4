"""PNG reader in numpy and the standard library's ``zlib``: the RGB-D frames
of ``fusion/fragments.py`` (16-bit depth, 8-bit color) without PIL, which
the card's machine may not have.

``read_png`` takes non-interlaced 8- and 16-bit (big-endian) gray, gray +
alpha, RGB and RGBA files, and undoes all five row filters. Paeth and Average
rows depend on the pixel to their left, which is sequential along a row; the
decoder walks the image by anti-diagonals instead (pixel (r, k) needs
(r, k - 1), (r - 1, k) and (r - 1, k - 1), all on the two diagonals before
it), a vectorized step per diagonal over every row at once. Palette,
interlaced (Adam7) and sub-byte files are refused.

``to_luma`` is PIL's ``convert("L")`` bit for bit:
(19595 R + 38470 G + 7471 B + 0x8000) >> 16.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples a pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter_rows(body: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of filters None, Sub and Up only: one vectorized step a row."""
    h, row_bytes = body.shape
    out = np.empty_like(body)
    prev = np.zeros(row_bytes, np.uint8)
    for r in range(h):
        x = body[r]
        if ft[r] == 1:
            x = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft[r] == 2:
            x = x + prev
        out[r] = x
        prev = out[r]
    return out


def _unfilter_wavefront(body: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: the image in skewed storage S[d + 2, r + 1] = pixel
    (r, k = d - r), so that each anti-diagonal d is one contiguous run of
    rows and its left (a), upper (b) and upper-left (c) neighbours are runs
    of the two diagonals before it; cells outside the image stay 0, the
    value the filters give a missing neighbour."""
    h, row_bytes = body.shape
    w = row_bytes // bpp
    px = body.reshape(h, w, bpp)
    n_diag = h + w - 1
    rr, kk = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dd = rr + kk
    raw = np.zeros((n_diag, h, bpp), np.int16)
    raw[dd, rr] = px
    S = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    zeros = np.zeros((h, bpp), np.int16)
    ftc = ft.astype(np.int64)[:, None]
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h - 1, d)
        a = S[d + 1, lo + 1:hi + 2]
        b = S[d + 1, lo:hi + 1]
        c = S[d, lo:hi + 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftc[lo:hi + 1], [zeros[:hi + 1 - lo], a, b, (a + b) >> 1, paeth])
        S[d + 2, lo + 1:hi + 2] = (raw[d, lo:hi + 1] + pred) & 0xFF
    return S[dd + 2, rr + 1].astype(np.uint8).reshape(h, row_bytes)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] (gray) or [H, W, C] array, uint8 or uint16."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported")
    if color == 3:
        raise ValueError("palette PNG files are not supported")
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: color type {color}, bit depth {depth}")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size < h * (1 + w * bpp):
        raise ValueError(f"PNG image data holds {rows.size} bytes, fewer than its "
                         f"{h} x {w} pixels need")
    rows = rows[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    ft, body = rows[:, 0], rows[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"bad PNG row filter type {int(ft.max())}")
    if np.isin(ft, (3, 4)).any():
        out = _unfilter_wavefront(body, ft, bpp)
    else:
        out = _unfilter_rows(body, ft, bpp)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    out = out.reshape(h, w, ch)
    return out[..., 0] if ch == 1 else out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_luma(img: np.ndarray) -> np.ndarray:
    """8-bit luma [H, W] of a decoded image, PIL's ``convert("L")``: gray as
    it is, gray + alpha its gray, RGB(A) by ITU-R 601-2 in 16-bit fixed
    point. A 16-bit color image is taken by its high bytes (as PIL reads
    it); 16-bit gray is clipped at 255 (PIL's I;16 -> L)."""
    if img.ndim == 2:
        return np.minimum(img, 255).astype(np.uint8)
    if img.dtype == np.uint16:
        img = img >> 8
    if img.shape[-1] == 2:
        return img[..., 0].astype(np.uint8)
    rgb = img[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000)
            >> 16).astype(np.uint8)
