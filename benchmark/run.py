"""The PyTorch / H100 port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cells). A run sets up
(builds the kernel libraries, reads the weights, makes the traffic from the
seed, warms up), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
compared number beside its limit (also the last lines of standard error).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result: it never runs on the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

# libraries the port uses must not load JAX on their own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "pointdsc_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        overrides: dict | None = None, t0: float | None = None) -> dict:
    """One run of ``workload``; returns the result object. ``device``
    (default the first card) and ``overrides`` let tests drive a run on the
    CPU at a small size."""
    import torch

    from harness import cell as cells
    from harness import compare

    t0 = T0 if t0 is None else t0
    device = torch.device(device or "cuda")
    cell = cells.cell(workload, overrides=overrides)
    loop = cell.loop()
    state = loop.setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    record = loop.window(state, seconds, cell.traffic["trace_items"] if trace else 0)
    record["setup_s"] = setup_s
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    kept = loop.release(state)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"refusing to report: loaded {', '.join(found)}")
    clock = time.perf_counter()
    result = loop.check(cell, kept, device)
    check_s = time.perf_counter() - clock
    held = compare.held(result["numbers"], cell.limits)
    metrics = {}
    for entry, reader in cell.metric_readers(trace):
        value = reader.read(record, cell)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out = {"correct": bool(held) and all(w for _, _, w in held.values()),
           "attempted": record["items"], "failed": result["failed"], "metrics": metrics,
           "device": dev}
    if trace:
        t = record["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["info"] = {"compared": result["compared"], "check_s": check_s,
                   "card": power_limit() if cuda else "cpu",
                   "numbers": result["numbers"], "worst": result["worst"],
                   **{k: record[k] for k in ("flipped", "slack", "setup_stages") if k in record}}
    out["check"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in held.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import cell as cells

    chips = cells.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
