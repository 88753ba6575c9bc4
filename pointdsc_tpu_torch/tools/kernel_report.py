"""Registers, spills and tensor-core instructions of the CUDA kernels, on a
machine with the CUDA toolkit.

    python -m pointdsc_tpu_torch.tools.kernel_report [--csrc DIR] [--out FILE]

Compiles the two sources of ``kernels/csrc`` that hold the attention loop,
``sc_attention`` and ``encoder_layer`` (which also holds the split PointCN +
QKV kernel), the seed k-NN's ``seed_knn`` and the refinement's ``refine``,
with the build's flags into a cubin, with ``-Xptxas -v``, and reads its SASS with
``cuobjdump --dump-sass``. Prints one JSON object per kernel: registers,
spill stores and loads (bytes), stack frame, and the count of each ``HMMA``
form (the tensor-core instructions), and a SHA-256 of its SASS instructions
(addresses and encodings left out), so that two trees' kernels can be shown
to compile to the same code. ``--csrc`` compiles the sources of another
directory (another tree's ``kernels/csrc``). The cubins go to the git-ignored
build directory.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
from collections import Counter

from pointdsc_tpu_torch.kernels import _build

SOURCES = ("sc_attention", "encoder_layer", "seed_knn", "refine")


def _tool(name: str) -> str:
    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    return path if os.path.exists(path) else (shutil.which(name) or name)


def _demangle(names):
    """Demangled names through cu++filt where the toolkit has it."""
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def ptxas_report(log: str) -> dict:
    """{mangled kernel: {registers, spill_stores, spill_loads, stack}} from
    the ``-Xptxas -v`` output."""
    info: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return info


def sass_hmma(sass: str) -> dict:
    """{mangled kernel: Counter of HMMA forms} from ``cuobjdump --dump-sass``."""
    counts: dict[str, Counter] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), Counter())
            continue
        m = re.search(r"\b(HMMA\.[A-Z0-9.]+)", line)
        if m and current is not None:
            current[m.group(1)] += 1
    return counts


def sass_digest(sass: str) -> dict:
    """{mangled kernel: SHA-256 of its instructions} from ``cuobjdump
    --dump-sass``, each instruction without its address and encoding."""
    text: dict[str, list] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = text.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+([^;]*;)", line)
        if m and current is not None:
            current.append(" ".join(m.group(1).split()))
    return {name: hashlib.sha256("\n".join(lines).encode()).hexdigest()
            for name, lines in text.items()}


def report(name: str, csrc: str = _build.CSRC) -> list[dict]:
    out_dir = os.path.join(_build.BUILD_DIR, "report")
    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.join(out_dir, f"{name}.cubin")
    proc = subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-cubin", "-Xptxas", "-v",
                           "-o", cubin, os.path.join(csrc, f"{name}.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    info = ptxas_report(proc.stdout + proc.stderr)
    sass = subprocess.run([_tool("cuobjdump"), "--dump-sass", cubin], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hmma = sass_hmma(sass)
    digest = sass_digest(sass)
    mangled = sorted(set(info) | set(hmma))
    rows = []
    for mangled_name, pretty in zip(mangled, _demangle(mangled)):
        rows.append({"source": f"{name}.cu", "kernel": pretty, **info.get(mangled_name, {}),
                     "hmma": dict(hmma.get(mangled_name, {})),
                     "sass_sha256": digest.get(mangled_name)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=_build.CSRC)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    lines = []
    for name in SOURCES:
        if not os.path.exists(os.path.join(args.csrc, f"{name}.cu")):
            continue
        for row in report(name, args.csrc):
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
