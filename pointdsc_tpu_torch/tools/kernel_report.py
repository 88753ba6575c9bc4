"""Registers, spills and tensor-core instructions of the CUDA kernels, on a
machine with the CUDA toolkit.

    python -m pointdsc_tpu_torch.tools.kernel_report [--csrc DIR] [--out FILE]
        [--compare PARENT.jsonl]

Compiles the two sources of ``kernels/csrc`` that hold the attention loop,
``sc_attention`` and ``encoder_layer`` (which also holds the split PointCN +
QKV kernel), the seed k-NN's ``seed_knn``, the refinement's ``refine``, the
int8 cache's ``compat_cache``, the seed NMS's ``nms``, the seed stage's
``scoring`` (which shares ``csrc/horn.cuh`` with ``refine``), the training
kernels' ``sc_attention_train`` and ``sm_loss``, the confidence head's
``conf_mlp``, the nearest-neighbour search's ``nn_search`` and the symmetric
int8 cache's ``compat_cache_sym``, with the build's
flags into a cubin, with ``-Xptxas -v``, and reads its SASS with
``cuobjdump --dump-sass``. Prints one JSON object per kernel: registers,
spill stores and loads (bytes), stack frame, and the count of each ``HMMA``
form (the tensor-core instructions), the instructions of each loop (a
backward branch and the code it jumps back over, largest first) and how
many of them lie on a rare path, and a SHA-256 of its SASS instructions
(addresses and encodings left out), so that two trees' kernels can be shown
to compile to the same code.
``--csrc`` compiles the sources of another directory (another tree's
``kernels/csrc``). ``--compare`` reads another tree's report (its
``--out``) and prints, for each of its kernels, whether a kernel of the same
name here (template arguments and parameters aside) has the same SASS, the
two digests side by side. The cubins go to the git-ignored build directory.

With a card, two more objects: the int8 cache kernels' issue floors. The
full-grid kernel's row loop (the 128-bit store instantiation's) computes 16
entries a thread; its instructions less its rare ones (the row's fallback to
sqrtf, taken only for a row holding a zero distance), over 16, are the
instructions an entry; at one instruction a lane a cycle on every SM at the
card's maximum SM clock (``nvidia-smi``), N^2 entries take at least
``issue_floor_ms``. The symmetric kernel's band loop (its largest; the
128-bit store instantiation's) is one band of a thread: its row loop (the
second largest) 8 times, each row's 16 columns computed, stored and staged,
and the mirror's loads and stores; those common instructions times the
block's 128 threads, over the 32 x 512 x 2 bytes a mirrored band writes,
are the instructions an output byte, and the
triangle's bands (each counted as a mirrored one: the diagonal block's skip
the mirror) take at least ``issue_floor_ms``.
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
from pointdsc_tpu_torch.kernels.sc_attention import SYM_BAND, SYM_COLS, symmetric_cache_plan

SOURCES = ("sc_attention", "encoder_layer", "seed_knn", "refine", "compat_cache", "nms",
           "scoring", "sc_attention_train", "sm_loss", "conf_mlp", "nn_search",
           "compat_cache_sym")
CACHE_COLUMNS = 16  # entries a thread computes in one pass of the cache kernel's row loop
FLOOR_SIZES = (5120, 12288, 20480)
SYM_WARPS = 4  # the symmetric kernel's warps a block (128 threads)
SYM_BAND_BYTES = 2 * SYM_BAND * SYM_COLS  # the bytes a block's mirrored band writes
SYM_ROWS = SYM_BAND // SYM_WARPS  # the rows a warp of the symmetric kernel computes a band


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


def _is_call(text: str) -> bool:
    op = text.split()[1] if text.startswith("@") else text.split()[0]
    return op.startswith("CALL")


def sass_loops(sass: str) -> dict:
    """{mangled kernel: [{"instructions", "rare"} of each loop, largest
    first]}: for every branch to a lower address, the instructions from its
    target to it, and how many of them lie in a region that a forward branch
    skips and that holds a call (a rare path, such as sqrtf's slow path,
    which the common path jumps over)."""
    loops: dict[str, list] = {}
    code: list = []
    # "BRA 0x..", "BRA P1, 0x.." (a second predicate), "BRA `(.L_x_1) 0x.."
    target = re.compile(r"\bBRA\S*\s+(?:!?U?P\w+,\s*)?(?:`\(\S+\)\s*)?0x([0-9a-f]+)")

    def close():
        if current is None:
            return
        rare = set()
        for i, (here, text) in enumerate(code):
            m = target.search(text)
            if m and int(m.group(1), 16) > here:
                skipped = [j for j in range(i + 1, len(code)) if code[j][0] < int(m.group(1), 16)]
                if any(_is_call(code[j][1]) for j in skipped):
                    rare.update(skipped)
        for i, (here, text) in enumerate(code):
            m = target.search(text)
            if m and int(m.group(1), 16) < here:
                body = [j for j in range(i + 1) if code[j][0] >= int(m.group(1), 16)]
                loops[current].append({"instructions": len(body),
                                       "rare": sum(j in rare for j in body)})
        loops[current].sort(key=lambda d: -d["instructions"])

    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            current, code = m.group(1), []
            loops[current] = []
            continue
        m = re.search(r"/\*([0-9a-f]+)\*/\s+([^;]*;)", line)
        if m and current is not None:
            code.append((int(m.group(1), 16), " ".join(m.group(2).split())))
    close()
    return loops


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
    loops = sass_loops(sass)
    digest = sass_digest(sass)
    mangled = sorted(set(info) | set(hmma))
    rows = []
    for mangled_name, pretty in zip(mangled, _demangle(mangled)):
        rows.append({"source": f"{name}.cu", "kernel": pretty, **info.get(mangled_name, {}),
                     "hmma": dict(hmma.get(mangled_name, {})),
                     "loops": loops.get(mangled_name, []),
                     "sass_sha256": digest.get(mangled_name)})
    return rows


def _card_clock():
    """(name, power limit, max SM clock in MHz, SMs) of the card present."""
    import torch

    query = "--query-gpu=name,power.limit,clocks.max.sm"
    name, power, mhz = (v.strip() for v in subprocess.run(
        ["nvidia-smi", query, "--format=csv,noheader,nounits"], capture_output=True,
        text=True, check=True, timeout=60).stdout.splitlines()[0].split(","))
    return name, power, float(mhz), torch.cuda.get_device_properties(0).multi_processor_count


def _loops(rows: list[dict], pattern: str) -> list[dict]:
    """The loops of the kernel whose name matches pattern, largest first."""
    return next((r["loops"] for r in rows if re.search(pattern, r["kernel"])), [])


def _common(loop: dict) -> int:
    return loop["instructions"] - loop["rare"]


def cache_issue_floors(rows: list[dict]) -> list[dict]:
    """The int8 cache kernels' instructions an entry (the full grid) or an
    output byte (the symmetric kernel) and their issue floors at
    FLOOR_SIZES on the card present (none without one)."""
    import torch

    full = _loops(rows, r"compat_cache_kernel<(true|\(bool\)1)>")[:1]
    sym = _loops(rows, r"compat_cache_sym_kernel<(\(int\))?16>")[:2]
    if not (full or len(sym) == 2) or not torch.cuda.is_available():
        return []
    name, power, mhz, sms = _card_clock()
    lanes_per_s = sms * 128 * mhz * 1e6
    card = {"card": f"{name}, {power} W", "sms": sms, "max_sm_clock_mhz": mhz}
    out = []
    if full:
        per_entry = _common(full[0]) / CACHE_COLUMNS
        out.append({"kernel": "compat_cache_kernel issue floor", **card, "row_loop": full[0],
                    "instructions_per_entry": per_entry,
                    "issue_floor_ms": {str(n): n * n * per_entry / lanes_per_s * 1e3
                                       for n in FLOOR_SIZES}})
    if len(sym) == 2:
        band, row = sym  # the row loop runs SYM_ROWS times a pass of the band loop
        per_band = (_common(band) - _common(row) + SYM_ROWS * _common(row)) * 32 * SYM_WARPS

        def bands(n):  # the triangle's
            return sum(count for _, _, count in symmetric_cache_plan(1, n, sms))

        out.append({"kernel": "compat_cache_sym_kernel issue floor", **card, "band_loop": band,
                    "row_loop": row,
                    "instructions_per_output_byte": per_band / SYM_BAND_BYTES,
                    "issue_floor_ms": {str(n): bands(n) * per_band / lanes_per_s * 1e3
                                       for n in FLOOR_SIZES}})
    return out


def base_name(kernel: str) -> str:
    """A demangled kernel's name without its namespace, template arguments
    and parameters."""
    for anonymous in ("(anonymous namespace)::", "<unnamed>::"):
        kernel = kernel.replace(anonymous, "")
    m = re.match(r"\s*(?:void\s+)?(?:[\w:]*::)?(\w+)", kernel)
    return m.group(1) if m else kernel


def compare(parent: list[dict], rows: list[dict]) -> list[dict]:
    """For each kernel of ``parent``: its digest, the digests of this tree's
    kernels of the same name, and whether one of them is its own."""
    out = []
    for p in parent:
        if "sass_sha256" not in p:
            continue
        name = base_name(p["kernel"])
        here = [r["sass_sha256"] for r in rows
                if "sass_sha256" in r and base_name(r["kernel"]) == name]
        out.append({"compare": name, "source": p["source"], "parent_kernel": p["kernel"],
                    "parent_sha256": p["sass_sha256"], "this_sha256": here,
                    "same_sass": p["sass_sha256"] in here})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=_build.CSRC)
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args(argv)
    lines, rows = [], []
    for name in SOURCES:
        if not os.path.exists(os.path.join(args.csrc, f"{name}.cu")):
            continue
        for row in report(name, args.csrc):
            rows.append(row)
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    for floor in cache_issue_floors(rows):
        lines.append(json.dumps(floor))
        print(lines[-1], flush=True)
    if args.compare:
        with open(args.compare) as f:
            parent = [json.loads(line) for line in f if line.strip()]
        for line in compare(parent, rows):
            lines.append(json.dumps(line))
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
