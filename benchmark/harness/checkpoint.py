"""Reader of the release checkpoints (flax msgpack): a frozen copy of the
program's pure-Python reader (``pointdsc_tpu_torch/compat/flax_msgpack.py``,
reading half) and of its flax-to-torch name map
(``pointdsc_tpu_torch/compat/weights.py::from_flax_variables``), so that the
benchmark reads the weights itself and hands the same state dict to the
program and to the reference.

    params/.../<name>/kernel [in, out]  ->  <path>.<name>.weight [out, in]
    params/.../<name>/bias              ->  <path>.<name>.bias
    params/.../<bn>/scale               ->  <path>.<bn>.weight
    batch_stats/.../<bn>/mean, var      ->  <path>.<bn>.running_mean, running_var
    params/sigma                        ->  sigma
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


_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var", "sigma": "sigma"}


def _walk(tree: dict, prefix: tuple = ()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def state_dict_arrays(path: str) -> dict[str, np.ndarray]:
    """The checkpoint at ``path`` as {state-dict name: float32 array}, Dense
    kernels transposed to [out, in]. Raises on a leaf name it does not
    know."""
    with open(path, "rb") as f:
        raw = loads(f.read())
    state = {}
    for collection in ("params", "batch_stats"):
        for keys, value in _walk(raw.get(collection, {})):
            leaf = keys[-1]
            if leaf not in _LEAF:
                raise KeyError(f"unknown flax leaf {'/'.join(keys)}")
            arr = np.array(value, dtype=np.float32)
            if leaf == "kernel":
                arr = np.ascontiguousarray(arr.T)
            state[".".join(keys[:-1] + (_LEAF[leaf],))] = arr
    return state
