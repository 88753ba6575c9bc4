"""Native C++ components, loaded via ctypes (the port's counterpart of
``pointdsc_tpu/native/__init__.py``).

- ``max_clique``: the exact maximum-clique solver behind the PMC baseline
  (``max_clique.cpp``);
- ``mincut_labels``: the exact s-t mincut (Dinic) behind GC-RANSAC's
  ``minimizer="exact"`` labeling (``maxflow.cpp``).

The two sources are byte copies of the JAX package's. Each library is built
with ``g++`` at first use (never at import), with the JAX package's Makefile
flags, into ``pointdsc_tpu_torch/_build/`` (git-ignored). Where this ``g++``
cannot link OpenMP (no libgomp installed), ``-fopenmp`` is left out: the
sources guard their OpenMP pragmas, and the clique search then runs on one
thread (``build_flags()`` says which). A library's file name carries a hash
of the source, the compiler command and what ``-march=native`` means on this
host, so a stale library, or one built for another CPU, is never loaded. A
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
from numpy.ctypeslib import ndpointer

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp", "-Wall", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}
_flags: tuple[str, ...] | None = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _host_target() -> bytes:
    """The macros ``-march=native`` defines here (the instruction sets the
    library may use)."""
    out = subprocess.run([_cxx(), "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                         check=True, capture_output=True)
    return out.stdout


def build_flags() -> tuple[str, ...]:
    """CXX_FLAGS, without ``-fopenmp`` where linking an empty library with it
    fails (checked once a process)."""
    global _flags
    if _flags is None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        probe = os.path.join(BUILD_DIR, f"openmp_probe.{os.getpid()}.so")
        try:
            ok = subprocess.run([_cxx(), "-fopenmp", "-fPIC", "-shared", "-x", "c++", os.devnull,
                                 "-o", probe], capture_output=True).returncode == 0
        finally:
            if os.path.exists(probe):
                os.remove(probe)
        _flags = CXX_FLAGS if ok else tuple(f for f in CXX_FLAGS if f != "-fopenmp")
    return _flags


def lib_path(name: str) -> str:
    """``_build/lib<name>_<hash>.so`` of source ``<name>.cpp``."""
    h = hashlib.sha256(" ".join((_cxx(),) + build_flags()).encode())
    h.update(_host_target())
    with open(os.path.join(_HERE, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Build ``<name>.cpp`` unless its library exists; returns its path."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_cxx(), *build_flags(), "-o", tmp, os.path.join(_HERE, f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _library(name: str, entry: str, restype, argtypes) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        fn = getattr(lib, entry)
        fn.restype = restype
        fn.argtypes = argtypes
        _loaded[name] = lib
    return lib


def _i32():
    return ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS")


def _f64():
    return ndpointer(ctypes.c_double, flags="C_CONTIGUOUS")


def mincut_labels(ei, ej, w, c_in, c_out, num_nodes):
    """Global minimum of the binary Potts MRF energy

        E(L) = sum_i [ L_i * c_in[i] + (1-L_i) * c_out[i] ]
             + sum_k w[k] * [L_{ei[k]} != L_{ej[k]}]

    via an exact s-t mincut (Dinic, ``maxflow.cpp``). Duplicate edges
    accumulate; non-finite or >= 1e15 unary costs clamp (inf c_in forces
    L_i = 0). Returns (energy: float, labels: bool [num_nodes])."""
    lib = _library("maxflow", "mincut_labels", ctypes.c_double,
                   [ctypes.c_int32, ctypes.c_int32, _i32(), _i32(), _f64(), _f64(), _f64(),
                    ndpointer(ctypes.c_uint8, flags="C_CONTIGUOUS")])
    ei = np.ascontiguousarray(ei, dtype=np.int32)
    ej = np.ascontiguousarray(ej, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float64)
    c_in = np.ascontiguousarray(c_in, dtype=np.float64)
    c_out = np.ascontiguousarray(c_out, dtype=np.float64)
    labels = np.zeros(max(num_nodes, 1), dtype=np.uint8)
    energy = lib.mincut_labels(num_nodes, len(ei), ei, ej, w, c_in, c_out, labels)
    return float(energy), labels[:num_nodes].astype(bool)


def max_clique(ei: np.ndarray, ej: np.ndarray, num_nodes: int) -> np.ndarray:
    """Exact maximum clique of the undirected graph given as an edge list
    (the reference ``pmc()`` wrapper's API, utils/max_clique.py:14-40).

    ei, ej: edge endpoints (0-based); num_nodes: the vertex count. Returns
    the clique's vertex indices, int32. Built with OpenMP, the solver
    searches in threads: where several maximum cliques exist, which one it
    returns may change from run to run."""
    lib = _library("max_clique", "max_clique", ctypes.c_int32,
                   [ctypes.c_int32, _i32(), _i32(), ctypes.c_int32, ctypes.c_int32, _i32()])
    ei = np.ascontiguousarray(ei, dtype=np.int32)
    ej = np.ascontiguousarray(ej, dtype=np.int32)
    outsize = max(num_nodes, 1)
    output = np.zeros(outsize, dtype=np.int32)
    size = lib.max_clique(len(ei), ei, ej, 0, outsize, output)
    return output[:size].copy()
