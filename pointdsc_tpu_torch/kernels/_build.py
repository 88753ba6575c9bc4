"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into
``pointdsc_tpu_torch/_build/`` (git-ignored), and loaded with ``ctypes``.
The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and a stale
library is never loaded. ``build_all`` starts one
``nvcc`` per source, all at once. ``builds`` counts the nvcc runs and
``loads`` the libraries loaded from disk in this process (which libraries a
run's set-up built again); under a running profiler the builds are
``pointdsc.kernels.build`` spans and the loads ``pointdsc.kernels.load``.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``launch`` raises when
that is not 0 (a refused launch never runs, and a later synchronize would
not report it). A kernel runs on PyTorch's current stream of its tensors'
device; a temporary the wrapper passed may be freed as soon as the wrapper
returns, because the caching allocator hands its memory only to work queued
later on the same stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from pointdsc_tpu_torch.utils.trace import span

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("compat_cache", "sc_attention", "sc_attention_train", "encoder_layer", "conf_mlp",
           "nms", "seed_knn", "scoring", "refine", "sm_loss", "nn_search", "compat_cache_sym",
           "sc_attention_cached")
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared", "-Xcompiler", "-fPIC")

# C signatures: (argtypes, restype) per entry point
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "compat_cache": {"compat_cache_int8": [P, P, P, I, I, F, P],
                     "compat_cache_int8_rect": [P] * 5 + [I, I, I, F, P]},
    "sc_attention": {"sc_attention_cached_wide": [P] * 6 + [I, I, I, F, P],
                     "sc_attention_cached_offset": [P] * 7 + [I, I, I, F, P],
                     "sc_attention_cached_rect": [P] * 7 + [I, I, I, I, F, I, P],
                     "sc_attention_nocache": [P] * 5 + [I, I, I, F, F, P]},
    "sc_attention_train": {"sc_attention_train_fwd": [P] * 6 + [I, I, I, F, F, P],
                           "sc_attention_train_bwd_dq": [P] * 8 + [I, I, I, F, F, P],
                           "sc_attention_train_bwd_dkv": [P] * 9 + [I, I, I, F, F, P]},
    "sm_loss": {"sm_loss_fwd": [P] * 4 + [I, P, I, I, I, P],
                "sm_loss_bwd": [P] * 6 + [I] * 5 + [P]},
    "encoder_layer": {"fused_encoder_layer": [P] * 19 + [I, I, F, F, P],
                      "pcn_qkv": [P] * 10 + [I, I, I, F, P],
                      "attn_mlp_residual": [P] * 15 + [I, I, I, I, F, P]},
    "conf_mlp": {"confidence_head": [P, P, P, I, P]},
    "nms": {"nms_local_max": [P] * 5 + [I, I, I, I, F, P, P, P, P],
            "nms_select": [P, P, P, I, P, P, P, P, I, I, I, P],
            "nms_top_m": [P] * 5 + [I, I, I, I, P]},
    "seed_knn": {"seed_knn_exact": [P] * 5 + [I] * 5 + [P]},
    "scoring": {"seed_hypotheses": [P] * 9 + [I] * 6 + [F, P],
                "seed_inlier_counts": [P] * 5 + [I, I, I, F, P],
                "select_hypothesis": [P] * 9 + [I, I, I, F, P]},
    "refine": {"fused_post_refinement": [P] * 6 + [I, I, F, I, P]},
    "nn_search": {"nearest_neighbors": [P] * 6 + [I] * 7 + [P]},
    "compat_cache_sym": {"compat_cache_sym": [P, P, P, I, I, P, I, I, F, P]},
    "sc_attention_cached": {"sc_attention_cached128": [P] * 10 + [I] * 5 + [F, P]},
}

_loaded: dict[str, ctypes.CDLL] = {}
builds = 0  # nvcc runs started
loads = 0  # libraries loaded from disk


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, tmp path, final path)."""
    global builds
    out = _lib_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    builds += 1
    return proc, tmp, out


def _finish_build(name, proc, tmp, out):
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all() -> float:
    """Build every kernel library (one nvcc per source, all in parallel) and
    return the wall seconds it took."""
    t0 = time.perf_counter()
    with span("pointdsc.kernels.build"):
        started = [(name, *_start_build(name)) for name in SOURCES]
        try:
            for name, proc, tmp, out in started:
                _finish_build(name, proc, tmp, out)
        finally:
            for _, proc, _, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    global loads
    lib = _loaded.get(name)
    if lib is None:
        started = _start_build(name)
        if started[0] is not None:
            with span("pointdsc.kernels.build"):
                _finish_build(name, *started)
        with span("pointdsc.kernels.load"):
            lib = ctypes.CDLL(_lib_path(name))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        loads += 1
        _loaded[name] = lib
    return lib


def launch(name: str, entry: str, device, *args) -> None:
    """Call C entry ``entry`` of library ``name`` with ``args`` and the
    current stream of ``device`` (a CUDA torch.device), with that device
    current; raise if the launch failed. The raw stream handle and the
    current device are read without Stream objects or a device switch when
    the device is already current: a launch's host time is the forward's
    (the eval forward is host-bound)."""
    import torch

    fn = getattr(library(name), entry)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if torch.cuda.current_device() == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"CUDA launch of {entry} failed with cudaError {err}")
