"""Minimal pure-Python msgpack reader and writer for flax checkpoints.

``dumps`` writes what ``flax.serialization.msgpack_restore`` reads: nested
dicts with string keys, lists, str, int, float, bool, None and numpy arrays
(extension type 1, a packed ``[shape, dtype_name, bytes]``).

``loads`` reads what ``flax.serialization.to_bytes`` writes, without flax or msgpack:
maps, arrays, str, bin, ints, floats, nil and bool, plus flax's extension
types 1 (ndarray: a packed ``[shape, dtype_name, bytes]``) and 3 (numpy
scalar, the same packing). Arrays come back as read-only numpy arrays over
the file's bytes, as flax returns them.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self):
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        if t in sized:
            kind, fmt = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        scalars = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if t in scalars:
            return self.unpack(scalars[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(self.unpack(">b"), fixext[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, buf = _Reader(payload).value()
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 arrays are not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def loads(data: bytes):
    """Decode one msgpack object (a flax state dict) from bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load(path: str):
    with open(path, "rb") as f:
        return loads(f.read())


def _pack_len(n: int, fix_base, fix_max: int, codes) -> bytes:
    """Header of a str/array/map/bin of n items: the fix form where one
    exists, else the shortest sized form of ``codes`` ((byte, fmt), ...)."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of {n} items is too large for msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (int, np.integer)):
        out.append(b"\xd3" + struct.pack(">q", int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(b"\xcb" + struct.pack(">d", float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_pack_len(len(raw), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))))
        out.append(raw)
    elif isinstance(obj, bytes):
        out.append(_pack_len(len(obj), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I"))))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I"))))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"msgpack map keys must be str here, got {type(key).__name__}")
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise TypeError("object arrays cannot be serialised")
        payload: list = []
        _pack([list(obj.shape), obj.dtype.name, obj.tobytes("C")], payload)
        body = b"".join(payload)
        out.append(_pack_len(len(body), None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I"))))
        out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(body)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def dumps(obj) -> bytes:
    """Encode a state dict (see the module docstring) as msgpack bytes."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
