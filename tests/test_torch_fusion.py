"""RGB-D fusion in the port against the JAX package, on the CPU: the camera
model, the normals and image gradients, bilinear sampling, depth and RGB-D
odometry, TSDF integration and surface extraction on an 80 x 60 image and a
32^3 grid, ``build_fragment`` from arrays; and ``data/png.py`` against PIL.

The JAX side runs with 64-bit types off (its accelerator's mode). Every
projection is followed by a ``round`` to a pixel, and the two packages
round the products before it differently (XLA's matrix product, the port's
elementwise sums), so a voxel or a point near a pixel's edge can go to the
neighbouring pixel: the TSDF and the surface points are compared by the
share of entries within 1e-6 (>= 0.98 of the voxels, measured 0.989) and
of points within 1e-5 of JAX's (>= 0.95), the weights by the share that
equals (>= 0.999). The odometries' transforms agree within 1e-5 (measured
<= 2.2e-7) and their inlier fractions exactly; the normals within 1e-6;
gradients and bilinear samples exactly. The PNG decoder equals PIL's
decode bit for bit.
"""

import io
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from pointdsc_tpu.data import transforms_np as T  # noqa: E402
from pointdsc_tpu.fusion import camera as jcam  # noqa: E402
from pointdsc_tpu.fusion import fragments as jfrag  # noqa: E402
from pointdsc_tpu.fusion import odometry as jodo  # noqa: E402
from pointdsc_tpu.fusion import tsdf as jtsdf  # noqa: E402
from pointdsc_tpu_torch.data import png  # noqa: E402
from pointdsc_tpu_torch.fusion import camera as tcam  # noqa: E402
from pointdsc_tpu_torch.fusion import fragments as tfrag  # noqa: E402
from pointdsc_tpu_torch.fusion import odometry as todo  # noqa: E402
from pointdsc_tpu_torch.fusion import tsdf as ttsdf  # noqa: E402
from test_fusion import render_plane_depth  # noqa: E402

W, H = 80, 60
J_INTR = jcam.PinholeIntrinsics(W, H, 70.0, 70.0, 39.5, 29.5)
T_INTR = tcam.PinholeIntrinsics(W, H, 70.0, 70.0, 39.5, 29.5)


def x32():
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def frames(n=2, step=(0.02, -0.01, 0.015), deg=0.004, seed=0):
    """Depth of the bumpy plane of the JAX fusion tests seen from a camera
    moving by ``step`` and ``deg`` a frame (a pixel's worth at 2 m), with a
    smooth intensity texture of the world point each pixel sees."""
    rng = np.random.default_rng(seed)
    poses, depths, colors = [np.eye(4)], [], []
    for _ in range(n - 1):
        poses.append(poses[-1] @ T.integrate_trans(T.rotation_matrix(3, deg, rng),
                                                   np.asarray(step)))
    for pose in poses:
        d = render_plane_depth(J_INTR, pose)
        uu, vv = np.meshgrid(np.arange(W) - 39.5, np.arange(H) - 29.5)
        pts = np.stack([uu / 70.0 * d, vv / 70.0 * d, d], -1) @ pose[:3, :3].T + pose[:3, 3]
        tex = 0.5 + 0.25 * np.sin(9.0 * pts[..., 0]) + 0.2 * np.cos(7.0 * pts[..., 1]
                                                                  + 2.0 * pts[..., 0])
        depths.append(d)
        colors.append(tex.astype(np.float32))
    return poses, depths, colors


def test_backproject_and_project_match_jax():
    _, (d,), _ = frames(1)
    d = d.copy()
    d[5:9, 10:20] = 0.0  # invalid pixels
    d[20, 30] = 5.0  # beyond the truncation
    with x32():
        jp, jv = jcam.backproject_depth(jnp.asarray(d), J_INTR)
        juv, jf = jcam.project_points(jp, J_INTR)
    tp, tv = tcam.backproject_depth(torch.from_numpy(d), T_INTR)
    tuv, tf = tcam.project_points(tp, T_INTR)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-7, atol=0)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=0, atol=2e-5)
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    ok = tf.numpy()
    np.testing.assert_allclose(tuv.numpy()[ok], np.stack([us, vs], -1).reshape(-1, 2)[ok],
                               atol=1e-4)


def test_normals_gradients_bilinear_match_jax(rng):
    _, (d,), (c,) = frames(1)
    d = d.copy()
    d[:, 70:] = 0.0  # an invalid band: zero normals, and the wrap at the border
    uv = rng.uniform(-3.0, W + 2.0, (800, 2)).astype(np.float32)
    uv[:, 1] *= H / W
    uv[:10] = [[0, 0], [W - 1, H - 1], [W - 1, 0], [0, H - 1], [W - 1.5, 3], [2.5, H - 1],
               [-1e-3, 4], [4, H - 1 + 1e-3], [39.5, 29.5], [10, 10]]
    with x32():
        jn = np.asarray(jodo.depth_normals(jnp.asarray(d), J_INTR))
        jgx, jgy = (np.asarray(g) for g in jodo.image_gradients(jnp.asarray(c)))
        jb, ji = (np.asarray(v) for v in jodo._bilinear(jnp.asarray(c), jnp.asarray(uv)))
    tn = todo.depth_normals(torch.from_numpy(d), T_INTR).numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-6, rtol=0)
    assert (np.abs(tn).sum(-1) == 0).sum() == (np.abs(jn).sum(-1) == 0).sum() > 10 * H
    tgx, tgy = todo.image_gradients(torch.from_numpy(c))
    np.testing.assert_array_equal(tgx.numpy(), jgx)
    np.testing.assert_array_equal(tgy.numpy(), jgy)
    tb, ti = todo._bilinear(torch.from_numpy(c), torch.from_numpy(uv))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-7, rtol=0)


@pytest.mark.parametrize("kind", ["depth", "rgbd", "rgbd_init"])
def test_odometry_matches_jax(kind):
    poses, (d0, d1), (c0, c1) = frames(2)
    gt = np.linalg.inv(poses[1]) @ poses[0]
    init = None
    if kind == "rgbd_init":
        init = np.asarray(T.integrate_trans(np.eye(3), [0.01, 0.0, 0.0]), np.float32)
    with x32():
        if kind == "depth":
            jt, jf = jodo.depth_odometry(jnp.asarray(d0), jnp.asarray(d1), J_INTR)
        else:
            jt, jf = jodo.rgbd_odometry(jnp.asarray(c0), jnp.asarray(d0), jnp.asarray(c1),
                                        jnp.asarray(d1), J_INTR,
                                        init_trans=None if init is None else jnp.asarray(init))
    if kind == "depth":
        tt, tf = todo.depth_odometry(d0, d1, T_INTR, device="cpu")
    else:
        tt, tf = todo.rgbd_odometry(c0, d0, c1, d1, T_INTR, init_trans=init, device="cpu")
    assert tt.dtype == torch.float32 and tt.shape == (4, 4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5, rtol=0)
    assert float(tf) == float(jf) > 0.8
    np.testing.assert_allclose(tt.numpy(), gt, atol=5e-3)


def tsdf_case():
    poses, depths, _ = frames(3, step=(0.03, 0.0, 0.0), deg=0.004)
    return poses, depths, dict(origin=np.array([-0.6, -0.5, 1.5]), voxel_size=0.03,
                               sdf_trunc=0.1, dims=(32, 32, 32))


def test_tsdf_integrate_and_surface_match_jax():
    poses, depths, kw = tsdf_case()
    with x32():
        jv = jtsdf.TSDFVolume(**kw)
        for d, p in zip(depths, poses):
            jv.integrate(jnp.asarray(d), J_INTR, jnp.asarray(p, jnp.float32))
        jpts = jtsdf.extract_surface_points(jv, min_weight=2.0)
    tv = ttsdf.TSDFVolume(**kw, device="cpu")
    for d, p in zip(depths, poses):
        tv.integrate(d, T_INTR, np.asarray(p, np.float32))
    tpts = ttsdf.extract_surface_points(tv, min_weight=2.0)
    t_tsdf, j_tsdf = tv.tsdf.numpy(), np.asarray(jv.tsdf)
    assert (tv.weight.numpy() == np.asarray(jv.weight)).mean() >= 0.999
    assert (np.abs(t_tsdf - j_tsdf) <= 1e-6).mean() >= 0.98
    assert len(tpts) > 300 and abs(len(tpts) - len(jpts)) <= 0.02 * len(jpts)
    d2 = ((tpts[:, None] - jpts[None]) ** 2).sum(-1).min(1)
    assert (d2 <= 1e-10).mean() >= 0.95
    assert np.abs(tpts[:, 2] - 2.0).max() < 0.2  # the bumpy plane at z = 2 +- 0.08


def test_build_fragment_from_arrays_matches_jax():
    poses, depths, colors = frames(4, step=(0.02, 0.0, 0.0), deg=0.004)
    kw = dict(voxel_size=0.03, sdf_trunc=0.1, keyframe_every=2, grid_dims=(40, 40, 32))
    with x32():
        jpts, jposes = jfrag.build_fragment(depths, intr=J_INTR, color_paths=colors, **kw)
    tpts, tposes = tfrag.build_fragment(depths, intr=T_INTR, color_paths=colors, device="cpu",
                                        **kw)
    np.testing.assert_allclose(np.stack(tposes), np.stack(jposes), atol=1e-5)
    for est, gt in zip(tposes, poses):
        np.testing.assert_allclose(est[:3, 3], gt[:3, 3], atol=0.01)
    assert abs(len(tpts) - len(jpts)) <= 0.02 * len(jpts) and len(tpts) > 200
    d2 = ((tpts[:, None] - jpts[None]) ** 2).sum(-1).min(1)
    assert (d2 <= 1e-10).mean() >= 0.95


def encode_png(img, filters=0):
    """[H, W] or [H, W, C] uint8 / uint16 -> PNG bytes with each row's filter
    type from ``filters`` (one, or one per row): PIL never writes Average."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    bpp = ch * img.dtype.itemsize
    body = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    body = body.reshape(h, w * bpp).astype(np.int32)
    ft = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    out = np.empty((h, 1 + w * bpp), np.uint8)
    out[:, 0] = ft
    for r in range(h):
        x = body[r]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        b = body[r - 1] if r else np.zeros_like(x)
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out[r, 1:] = (x - [np.zeros_like(x), a, b, (a + b) >> 1, paeth][ft[r]]) & 0xFF
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, {1: 0, 2: 4, 3: 2, 4: 6}[ch],
                       0, 0, 0)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(out.tobytes())) + chunk(b"IEND", b""))


def pil_png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def images(rng):
    """Smooth images (PIL picks Sub, Up and Paeth rows for them) and noise."""
    yy, xx = np.mgrid[0:47, 0:61]
    smooth = 120 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    return {
        "L": np.clip(smooth + rng.normal(0, 3, smooth.shape), 0, 255).astype(np.uint8),
        "I;16": (1500 + 900 * np.sin(xx / 9.0 + yy / 13.0)).astype(np.uint16),
        "RGB": np.clip(np.stack([smooth, smooth[::-1], 255 - smooth], -1)
                       + rng.normal(0, 4, smooth.shape + (3,)), 0, 255).astype(np.uint8),
        "RGBA": rng.integers(0, 256, (47, 61, 4), dtype=np.uint8),
    }


def row_filters(data: bytes) -> set:
    idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    header = dict(zip(("w", "h", "depth", "color"),
                      struct.unpack(">IIBB", next(b for k, b in png._chunks(data)
                                                  if k == b"IHDR")[:10])))
    row = 1 + header["w"] * png._CHANNELS[header["color"]] * header["depth"] // 8
    return set(np.frombuffer(zlib.decompress(idat), np.uint8)[::row].tolist())


@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "RGBA"])
def test_png_reads_pil_files(rng, mode, tmp_path):
    arr = images(rng)[mode]
    data = pil_png(arr)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    got = png.read_png(path)
    want = np.asarray(Image.open(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.to_luma(got), np.asarray(Image.open(path).convert("L")))
    if mode in ("L", "RGB"):
        assert 4 in row_filters(data), row_filters(data)  # PIL wrote Paeth rows


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "RGBA"])
def test_png_every_filter_against_pil(rng, mode, filters):
    """Each of the five row filters (PIL never writes Average) in our own
    encoder, decoded by PIL and by ``decode_png``."""
    arr = images(rng)[mode]
    ft = rng.integers(0, 5, arr.shape[0]) if filters == "mixed" else filters
    data = encode_png(arr, ft)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(want, arr)
    np.testing.assert_array_equal(png.decode_png(data), want)


def test_png_luma_formula_and_refusals(rng, tmp_path, monkeypatch):
    rgb = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    rgb[0, :8] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                  [1, 2, 3], [254, 1, 128], [128, 128, 128]]
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    c = rgb.astype(np.int64)
    np.testing.assert_array_equal(
        (19595 * c[..., 0] + 38470 * c[..., 1] + 7471 * c[..., 2] + 0x8000) >> 16, want)
    np.testing.assert_array_equal(png.to_luma(rgb), want)

    good = encode_png(rgb[..., 0])
    ihdr = good[8 + 8:8 + 8 + 13]
    laced = ihdr[:12] + b"\x01"
    data = (good[:8] + good[8:16] + laced + struct.pack(">I", zlib.crc32(b"IHDR" + laced))
            + good[8 + 8 + 13 + 4:])
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(data)
    with pytest.raises(ValueError, match="palette"):
        png.decode_png(_palette_png(rgb))
    with pytest.raises(ValueError, match="fewer than"):
        png.decode_png(encode_png(rgb[:8, :8, 0]).replace(b"IHDR\x00\x00\x00\x08",
                                                         b"IHDR\x00\x00\x00\x10"))

    path = str(tmp_path / "frame.jpg")
    Image.fromarray(rgb).save(path)
    np.testing.assert_array_equal(tfrag.read_intensity_png(path),
                                  np.asarray(Image.open(path).convert("L")) / np.float32(255))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="JPEG .*PIL"):
        tfrag.read_intensity_png(path)


def _palette_png(rgb):
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("P").save(buf, format="PNG")
    return buf.getvalue()


def test_png_frames_as_build_fragment_reads_them(tmp_path):
    """A 16-bit depth PNG in millimeters and an RGB frame, through
    ``read_depth_png`` / ``read_intensity_png``, as JAX's PIL-based readers."""
    _, (d,), (c,) = frames(1)
    mm = np.clip(d * 1000.0, 0, 65535).astype(np.uint16)
    rgb = np.clip(np.stack([c, c * 0.8, 1 - c], -1) * 255, 0, 255).astype(np.uint8)
    dpath, cpath = str(tmp_path / "d.png"), str(tmp_path / "c.png")
    Image.fromarray(mm).save(dpath)
    Image.fromarray(rgb).save(cpath)
    np.testing.assert_array_equal(tfrag.read_depth_png(dpath), jfrag.read_depth_png(dpath))
    np.testing.assert_array_equal(tfrag.read_intensity_png(cpath),
                                  jfrag.read_intensity_png(cpath))
