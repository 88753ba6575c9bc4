"""Minimal PLY point-cloud reader/writer (the port's own copy of
``pointdsc_tpu/data/ply.py``; numpy, no Open3D).

Handles ascii and binary_little_endian vertex elements with float/double
x/y/z (plus arbitrary extra properties, skipped): the reference's demo pair
(binary_little_endian float xyz) and fragment meshes' vertex clouds.
"""

from __future__ import annotations

import numpy as np

_TYPE_MAP = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("<u1", 1), "uint8": ("<u1", 1),
    "char": ("<i1", 1), "int8": ("<i1", 1),
    "short": ("<i2", 2), "int16": ("<i2", 2),
    "ushort": ("<u2", 2), "uint16": ("<u2", 2),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def read_ply_xyz(path: str) -> np.ndarray:
    """Read the vertex x/y/z coordinates from a .ply file -> [N, 3] float64."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break

        fmt = None
        num_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    num_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties in vertex element unsupported")
                props.append((parts[1], parts[2]))

        names = [p[1] for p in props]
        if not {"x", "y", "z"}.issubset(names):
            raise ValueError(f"{path}: vertex element lacks x/y/z ({names})")

        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=num_vertex)
            cols = [names.index(c) for c in ("x", "y", "z")]
            return data[:, cols].astype(np.float64)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported ply format {fmt}")

        dtype = np.dtype([(n, _TYPE_MAP[t][0]) for t, n in props])
        data = np.frombuffer(f.read(dtype.itemsize * num_vertex), dtype=dtype,
                             count=num_vertex)
        return np.stack(
            [data["x"], data["y"], data["z"]], axis=-1
        ).astype(np.float64)


def write_ply_xyz(path: str, xyz: np.ndarray) -> None:
    """Write [N, 3] points as a binary_little_endian .ply."""
    xyz = np.asarray(xyz, dtype=np.float32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(xyz)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(xyz.astype("<f4").tobytes())
