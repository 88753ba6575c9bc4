"""The readings that the correctness limits are set from, outside the
benchmark's runs: the control (the plain reference put in the program's
place, one precision step below what the configuration states) and the
fault a cell can have, planted in the reference put in the program's
place, each against the reference on the same inputs a run with that seed
compares.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--modes control,...]

Modes (one JSON line per seed and mode on standard output):
  control   bf16 for the float32 stages, fp8 (e4m3) attention operands, a
            15-level (int4) compatibility matrix;
  answer    the final transform moved by one inlier threshold.

The sound program's readings are the benchmark's own runs (their
``check`` key). Needs a CUDA card.
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(BENCH), BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def eval_readings(cell, seed: int, modes, device) -> dict:
    from harness import checkpoint, synthetic
    from harness.cell import ROOT

    loop = cell.loop()
    pool = synthetic.make_pool(cell.traffic, seed)
    kept = {"arrays": checkpoint.state_dict_arrays(os.path.join(ROOT, cell.config["weights"])),
            "pairs": {i: (pool[i], None) for i in loop.sample_indices(pool, cell.traffic, seed)}}
    out = {}
    for mode in modes:
        if mode == "control":
            program = loop.reference_answers(cell, kept, device, lowp=True)
        elif mode == "answer":
            program = loop.reference_answers(cell, kept, device)
            for answer in program.values():
                answer["trans"] = answer["trans"].copy()
                answer["trans"][0, 3] += cell.config["model"]["inlier_threshold"]
        else:
            raise ValueError(f"mode {mode!r} is neither control nor answer")
        out[mode] = loop.check(cell, kept, device, program=program)["numbers"]
    return out


def main(argv=None) -> int:
    import torch

    from harness import cell as cells

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.cell(args.workload)
    modes = args.modes.split(",") if args.modes else ["control", "answer"]
    for seed in map(int, args.seeds.split(",")):
        for mode, numbers in eval_readings(cell, seed, modes, torch.device("cuda")).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
