"""Closed-loop evaluation: one pair at a time through the program's
``Evaluator(fused_attention=True).run_pair``, as ``run_dataset`` drives
it, cycling a pool of synthetic pairs made from the seed.

Set-up builds the kernel libraries, reads the checkpoint, builds the model
with the configuration's keys (the softmax among them), makes the pool and
runs at least ``warmup_pairs`` pairs for at least ``warmup_seconds`` (the
bucket's first forward runs once unrecorded; on the offset softmax the
regime guard probes the first three pairs and the first of the bucket). The window then times every
``run_pair`` call by the host clock, from the call to its return (the
transform and labels read back).

The check compares, for a sample of pool pairs drawn from the seed (the
pair with the most points among them), the answers of their first run in
the window against the plain reference on the same raw pair.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from harness import checkpoint, compare, synthetic
from harness.cell import ROOT
from harness.trace import Tracer


@dataclass
class State:
    cell: object
    device: torch.device
    evaluator: object
    arrays: dict
    pool: list
    cursor: int
    sample: set
    capture: int | None = None
    outputs: dict = field(default_factory=dict)  # pool index -> its forward's output
    answers: dict = field(default_factory=dict)  # pool index -> its run_pair transform
    stages: dict = field(default_factory=dict)
    hooks: list = field(default_factory=list)
    spans: list | None = None  # the open model span while tracing


def model_state(arrays: dict, model) -> dict:
    """The checkpoint's tensors under the model's own state-dict names (a
    test's shallower model takes the first layers)."""
    return {k: torch.from_numpy(arrays[k]) for k in model.state_dict()}


def sample_indices(pool: list, traffic: dict, seed: int) -> set:
    """The pool pairs whose answers are compared: the largest pair and
    ``check_pairs - 1`` others drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    largest = int(np.argmax([p["corr_pos"].shape[0] for p in pool]))
    others = [int(i) for i in rng.permutation(len(pool)) if i != largest]
    return {largest, *others[:min(traffic["check_pairs"], len(pool)) - 1]}


def setup(cell, seed: int, device: torch.device) -> State:
    from pointdsc_tpu_torch.eval.runner import Evaluator
    from pointdsc_tpu_torch.kernels import _build
    from pointdsc_tpu_torch.models.pointdsc import PointDSC

    clock = time.perf_counter()
    if device.type == "cuda":
        _build.build_all()
    stages = {"build": time.perf_counter() - clock}
    cfg, traffic = cell.config, cell.traffic
    arrays = checkpoint.state_dict_arrays(os.path.join(ROOT, cfg["weights"]))
    model = PointDSC(**cfg["model"], device="cpu")
    model.load_state_dict(model_state(arrays, model), strict=True)
    model = model.to(device).eval()
    evaluator = Evaluator(model, re_thre=cfg["eval"]["re_thre"], te_thre=cfg["eval"]["te_thre"],
                          fused_attention=True, device=device)
    stages["model"] = time.perf_counter() - clock - sum(stages.values())
    pool = synthetic.make_pool(traffic, seed)
    stages["pool"] = time.perf_counter() - clock - sum(stages.values())
    state = State(cell, device, evaluator, arrays, pool, 0, sample_indices(pool, traffic, seed),
                  stages=stages)

    def enter(module, args):
        if state.spans is not None:
            span = torch.autograd.profiler.record_function("bench.model_forward")
            span.__enter__()
            state.spans.append(span)

    def keep(module, args, out):
        if state.capture is not None:
            state.outputs[state.capture] = out
        if state.spans:
            state.spans.pop().__exit__(None, None, None)
    state.hooks = [model.register_forward_pre_hook(enter), model.register_forward_hook(keep)]
    # the first pairs carry the bucket's unrecorded forward (and the guard's
    # probes on the offset softmax); the rest of the warm-up brings the card to its steady clocks
    warm_until = time.perf_counter() + traffic["warmup_seconds"]
    while state.cursor < traffic["warmup_pairs"] or time.perf_counter() < warm_until:
        evaluator.run_pair(pool[state.cursor % len(pool)])
        state.cursor += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages["warmup"] = time.perf_counter() - clock - sum(stages.values())
    return state


def window(state: State, seconds: float, trace_items: int = 0) -> dict:
    """Run pairs for ``seconds``; the first ``trace_items`` of them under the
    profiler. Returns the record the metric readers read."""
    ev, pool = state.evaluator, state.pool
    tracer = Tracer() if trace_items else None
    latencies, shapes, answers = [], [], {}
    trace = None
    if tracer is not None:
        tracer.__enter__()
        state.spans = []
    t0 = time.perf_counter()
    end, last = t0 + seconds, t0
    while last < end or (tracer is not None and trace is None):
        idx = state.cursor % len(pool)
        state.capture = idx if idx in state.sample and idx not in answers else None
        span = (torch.autograd.profiler.record_function("bench.run_pair")
                if state.spans is not None else contextlib.nullcontext())
        a = time.perf_counter()
        with span:
            _, trans = ev.run_pair(pool[idx])
        last = time.perf_counter()
        latencies.append(last - a)
        if state.capture is not None:
            answers[idx] = trans
        state.capture = None
        state.cursor += 1
        if tracer is not None and trace is None:
            shapes.append(pool[idx]["corr_pos"].shape[0])
            if len(shapes) == trace_items:
                state.spans = None
                tracer.__exit__(None, None, None)
                trace = tracer.summary()
    state.answers = answers
    return {"items": len(latencies), "window_s": last - t0, "latencies_s": latencies,
            "trace": trace, "traced_items": len(shapes), "shapes": shapes, "flipped": ev.flipped,
            "slack": ev.last_slack, "setup_stages": state.stages}


def release(state: State) -> dict:
    """Free the program's state; keep the compared pairs and answers."""
    kept = {"arrays": state.arrays, "pairs": {}}
    for idx, trans in state.answers.items():
        out = state.outputs[idx]
        n = state.pool[idx]["corr_pos"].shape[0]
        kept["pairs"][idx] = (state.pool[idx], {
            "trans": np.asarray(trans, np.float32),
            "labels": out.final_labels[0, :n].float().cpu().numpy(),
            "confidence": out.confidence[0, :n].float().cpu().numpy()})
    for hook in state.hooks:
        hook.remove()
    state.evaluator = state.outputs = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    return kept


def reference_answers(cell, kept: dict, device, lowp: bool = False) -> dict:
    """{pool index: the reference's answers} for the kept pairs."""
    ref = cell.reference()
    names = [k for k in kept["arrays"] if _in_model(k, cell.config["model"]["num_layers"])]
    sd = {k: torch.as_tensor(kept["arrays"][k], device=device) for k in names}
    cfg = dict(cell.config["model"])
    return {idx: ref.eval_forward(sd, pair, cfg, cell.traffic["bucket"], device, lowp=lowp)
            for idx, (pair, _) in kept["pairs"].items()}


def _in_model(name: str, layers: int) -> bool:
    for kind in ("PointCN", "NonLocal"):
        prefix = f"encoder.{kind}_layer_"
        if name.startswith(prefix):
            return int(name[len(prefix):].split(".")[0]) < layers
    return True


def check(cell, kept: dict, device, program: dict | None = None) -> dict:
    """The cell's numbers (the worst compared pair, and the median pair's
    ``conf_rms_median``) and how many pairs exceeded a limit held pair by
    pair. ``program`` replaces the program's answers (the
    control). A pair the reference itself does not register (its
    transform outside the protocol's RE / TE thresholds from the ground
    truth) is left out of the transform's comparison: there the model's
    answer is one of several wrong hypotheses of near-equal standing, and
    rounding picks which."""
    refs = reference_answers(cell, kept, device)
    thr = cell.config["model"]["inlier_threshold"]
    re_thre, te_thre = cell.config["eval"]["re_thre"], cell.config["eval"]["te_thre"]
    per, where, unregistered = [], [], 0
    for idx, (pair, answer) in kept["pairs"].items():
        prog = program[idx] if program is not None else answer
        numbers = compare.eval_pair(prog, refs[idx], pair, thr)
        if not compare.registered(refs[idx]["trans"], pair["gt_trans"], re_thre, te_thre):
            unregistered += 1
            numbers.pop("pose_gap")
        per.append(numbers)
        where.append({"pair": idx, "n": int(pair["corr_pos"].shape[0]),
                      "inliers": float(np.mean(pair["gt_labels"]))})
    numbers = {k: max(p[k] for p in per if k in p) for k in set().union(*per)}
    # the pool pair behind each worst number, with its size and inlier share
    worst = {k: where[max((i for i, p in enumerate(per) if k in p), key=lambda i: per[i][k])]
             for k in numbers}
    numbers["conf_rms_median"] = float(np.median([p["conf_rms"] for p in per]))
    numbers.setdefault("pose_gap", 0.0)  # no pair registered: nothing to hold
    numbers["_unregistered"] = unregistered
    failed = sum(1 for p in per if not all(within for _, _, within in
                                           compare.held(p, cell.limits).values()))
    return {"numbers": numbers, "worst": worst, "compared": len(per), "failed": failed}
