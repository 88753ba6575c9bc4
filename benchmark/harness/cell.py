"""Finding the pieces of a cell by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix; everything else is a file of its own, found
by name:

    configs given by the ``file`` of their BENCHMARK.json entry (JSON)
    benchmark/traffic/<traffic>.json    parameters of one traffic mix; its
                                        ``loop`` names its loop below
    benchmark/loops/<loop>.py           one kind of loop, general over cells
    benchmark/metrics/<metric>.py       one metric's reader, ``read(record)``
    benchmark/limits/<workload>.json    the correctness limits of one cell
    benchmark/reference/<reference>.py  the plain reference a config names

so that a later change adds a configuration, a mix, a cell or a metric by
adding files, without editing one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_module(path: str, name: str):
    """Import the Python file at ``path`` under the module name ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def loop(self):
        return load_module(os.path.join(BENCH, "loops", f"{self.traffic['loop']}.py"),
                           f"bench_loop_{self.traffic['loop']}")

    def reference(self):
        return load_module(os.path.join(BENCH, "reference", f"{self.config['reference']}.py"),
                           f"bench_reference_{self.config['reference']}")

    def metric_readers(self, trace: bool) -> list:
        """(metric entry, reader module) of the metrics this cell reports
        in a run with ``trace``: the end-to-end ones untraced, the
        per-layer ones traced."""
        entries = self.per_layer if trace else self.end_to_end
        return [(m, load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                                f"bench_metric_{m['name'].replace('.', '_')}")) for m in entries]


def spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(workload: str, root: str = ROOT, overrides: dict | None = None) -> Cell:
    """The cell named ``workload`` in BENCHMARK.json with its files read. ``overrides`` ({"config": {...},
    "traffic": {...}}) replaces entries of the two files, for tests at a
    small size."""
    s = spec(root)
    entries = {w["name"]: w for w in s["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[workload]
    configs = {c["name"]: c for c in s["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(BENCH, "limits", f"{workload}.json"))
    for key, target in (("config", config), ("traffic", traffic)):
        for k, v in (overrides or {}).get(key, {}).items():
            if isinstance(v, dict) and isinstance(target.get(k), dict):
                target[k] = {**target[k], **v}
            else:
                target[k] = v
    return Cell(workload, w["chips"], w["config"], config, w["traffic"], traffic, limits,
                [m for m in s["end_to_end"] if _applies(m, workload)],
                [m for m in s["per_layer"] if _applies(m, workload)])
