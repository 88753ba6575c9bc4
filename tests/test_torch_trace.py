"""The eval path's stage spans and counters (utils/trace.py, eval/runner.py,
models/pointdsc.py, models/blocks.py) and their reduction to device and
idle time by span (tools/profile_forward.py::span_times).

CPU: the span tree of ``Evaluator.run_pair`` under ``torch.profiler``, no
``record_function`` without a profiler, the Evaluator's counters, and
``span_times`` on synthetic events. The test marked ``cuda`` holds the spans
to 99% of a traced pair's device time on the card:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

from __future__ import annotations

import contextlib
import copy
import os
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointdsc_tpu_torch import PointDSC, load_pretrained
from pointdsc_tpu_torch.data import SyntheticPairDataset
from pointdsc_tpu_torch.eval import protocol, runner
from pointdsc_tpu_torch.eval.runner import Evaluator
from pointdsc_tpu_torch.tools.profile_forward import span_times

SNAP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "snapshot", "PointDSC_Synthetic_release")
LAYERS = 2
STAGES = ("cache", "encoder", "head", "nms", "seeds", "refine")


def small_model(offset_softmax=False):
    return PointDSC(num_layers=LAYERS, num_channels=32, k=8, offset_softmax=offset_softmax,
                    device="cpu", generator=torch.Generator().manual_seed(0))


def pairs(*sizes, seed=0):
    return [SyntheticPairDataset(num_pairs=1, num_corr=n, seed=seed + i)[0]
            for i, n in enumerate(sizes)]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_span_tree_of_a_pair(monkeypatch):
    """A traced pair on the running-max path: every ``pointdsc.eval.*``
    stage once, the model's stages once, the attention once a layer, each
    span under its parent; the root's ``args`` carry the pair's sequence
    number, n and bucket."""
    ev = Evaluator(small_model(), fused_attention=True, device="cpu")
    first, second = pairs(200, 220)  # one bucket: the second pair needs no warm-up
    ev.run_pair(first)
    seen = []
    record_function = torch.autograd.profiler.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return record_function(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.run_pair(second)
    spans = [e for e in prof.events() if e.name.startswith("pointdsc.")]
    want = Counter({f"pointdsc.eval.{s}": 1 for s in
                    ("pair", "pad", "to_device", "drain", "readback", "stats")})
    want.update({"pointdsc.model.forward": 1, "pointdsc.model.attention": LAYERS})
    want.update({f"pointdsc.model.{s}": 1 for s in STAGES})
    assert Counter(e.name for e in spans) == want
    parent = {"pointdsc.model.forward": "pointdsc.eval.pair",
              "pointdsc.model.attention": "pointdsc.model.encoder",
              **{f"pointdsc.eval.{s}": "pointdsc.eval.pair" for s in
                 ("pad", "to_device", "drain", "readback", "stats")},
              **{f"pointdsc.model.{s}": "pointdsc.model.forward" for s in STAGES}}
    for e in spans:
        assert (e.cpu_parent and e.cpu_parent.name) == parent.get(e.name)
    assert [args for name, args in seen if name == "pointdsc.eval.pair"] == [
        "pair=1 n=220 bucket=256"]
    times = span_times(prof.events())
    assert {k: v["n"] for k, v in times["spans"].items()} == dict(want)
    for st in times["spans"].values():
        assert 0.0 <= st["self_s"] <= st["host_s"] and st["device_s"] == 0.0
    # no device on the CPU: the window is idle, all of it inside the pair
    assert times["busy_s"] == times["outside_idle_s"] == 0.0
    idle = sum(st["idle_s"] for st in times["spans"].values())
    assert idle == pytest.approx(times["window_s"])


def test_first_pair_on_the_whole_layer_path():
    """A fresh Evaluator's first pair on the offset softmax: the guard's
    probe and the bucket's warm-up have spans, the warm-up a forward of its
    own; the whole-layer path has one ``pointdsc.model.layer`` a layer and
    no attention span."""
    ev = Evaluator(small_model(offset_softmax=True), fused_attention=True, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.run_pair(pairs(200)[0])
    assert not ev.flipped  # a flip would run the per-op encoder
    spans = [e for e in prof.events() if e.name.startswith("pointdsc.")]
    got = Counter(e.name for e in spans)
    assert got["pointdsc.eval.guard"] == got["pointdsc.eval.warmup"] == 1
    assert got["pointdsc.model.forward"] == 2
    assert got["pointdsc.model.layer"] == 2 * LAYERS
    assert got["pointdsc.model.attention"] == 0
    for e in spans:
        if e.name in ("pointdsc.eval.guard", "pointdsc.eval.warmup"):
            assert e.cpu_parent.name == "pointdsc.eval.pair"
        if e.name == "pointdsc.model.layer":
            assert e.cpu_parent.name == "pointdsc.model.encoder"


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    ev = Evaluator(small_model(), fused_attention=True, device="cpu")
    stats, agg = ev.run_dataset(pairs(200, 300, 220), verbose=False)
    assert stats.shape == (3, 12)
    ev = Evaluator(small_model(offset_softmax=True), fused_attention=True, device="cpu")
    ev.run_pair(pairs(200)[0])


def test_counters_pairs_and_warmups():
    """One pair a call, one warm-up a new bucket; no probe on the running
    max, and the counters in the aggregate and the report."""
    ev = Evaluator(small_model(), fused_attention=True, device="cpu")
    stats, agg = ev.run_dataset(pairs(200, 300, 250, 500), verbose=False)
    assert ev.counters == {"pairs": 4, "warmups": 2, "probes": 0, "flips": 0,
                           "unprobed_offset_forwards": 0}
    assert agg["counters"] == ev.counters
    assert ("regime guard: probes=0, flips=0, unprobed_offset_forwards=0"
            in protocol.format_scene_report(agg))
    ev.run_pair(pairs(600)[0])  # bucket 1024: a third warm-up
    assert ev.counters["pairs"] == 5 and ev.counters["warmups"] == 3
    assert agg["counters"]["pairs"] == 4  # the aggregate holds a copy


@pytest.mark.parametrize("flip_at", [None, 2])
def test_unprobed_offset_forwards(monkeypatch, flip_at):
    """On the offset softmax the guard probes the first three pairs (and a
    new bucket's first), each under a ``pointdsc.eval.guard`` span; the
    forwards after them count as unprobed. A flip ends both: the running
    max needs no probe."""
    calls, spans = [], []

    def probe(model, *args, **kwargs):
        calls.append(None)
        if len(calls) == flip_at:
            flipped = copy.copy(model)
            flipped.offset_softmax = False
            return flipped, 100.0, True
        return model, 1.0, False

    def span(name, args=None):
        spans.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(runner, "select_attention_kernels", probe)
    monkeypatch.setattr(runner, "span", span)
    ev = Evaluator(small_model(offset_softmax=True), fused_attention=True, device="cpu")
    sample, = pairs(200)
    for _ in range(6):
        ev.run_pair(sample)
    if flip_at is None:
        assert ev.counters == {"pairs": 6, "warmups": 1, "probes": 3, "flips": 0,
                               "unprobed_offset_forwards": 3}
    else:  # the flip clears the warmed buckets: the next pair warms again
        assert ev.counters == {"pairs": 6, "warmups": 2, "probes": 2, "flips": 1,
                               "unprobed_offset_forwards": 0}
    assert spans.count("pointdsc.eval.guard") == ev.counters["probes"]


def ev_(name, start, end, *, device=False, id=0, linked=0, kind=None):
    """A profiler event as ``span_times`` reads it (times in microseconds)."""
    kind = kind or ("kernel" if device else
                    "user_annotation" if name.startswith(("pointdsc.", "bench.")) else "cpu_op")
    return SimpleNamespace(
        name=name, id=id, linked_correlation_id=linked, activity_type=kind,
        is_user_annotation=kind in ("user_annotation", "gpu_user_annotation"),
        device_type=torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))


def test_span_times_on_synthetic_events():
    """Device time goes to the innermost span open at the launch (by the
    runtime call of the same correlation id, else the linked host
    operation), idle time to the innermost span open at the gap's middle,
    however many host events lie between; what falls outside every span is
    counted apart."""
    events = [
        ev_("pointdsc.eval.pair", 0, 1000),
        ev_("pointdsc.eval.pad", 10, 100),
        ev_("pointdsc.model.forward", 200, 700),
        ev_("pointdsc.model.attention", 300, 400),
        # a launch through the runtime inside the attention
        ev_("cudaLaunchKernel", 310, 320, id=501, linked=0, kind="cuda_runtime"),
        ev_("attention_kernel", 420, 520, device=True, id=501),
        # an aten op in the forward's own time whose kernel links to it only
        ev_("aten::addmm", 450, 460, id=77),
        ev_("gemm", 520, 560, device=True, id=999, linked=77),
        # a launch outside every span, and a span's mirror on the device
        ev_("cudaMemcpyAsync", 1100, 1110, id=600, kind="cuda_runtime"),
        ev_("Memcpy HtoD", 1120, 1130, device=True, id=600),
        ev_("pointdsc.model.attention", 420, 520, device=True, kind="gpu_user_annotation"),
        # many host events inside the pad span, between its start and a gap
        *[ev_("aten::empty", 11 + i * 0.01, 11.005 + i * 0.01) for i in range(1000)],
    ]
    t = span_times(events, window=(0, 1200))
    s = t["spans"]
    assert {k: v["n"] for k, v in s.items()} == {
        "pointdsc.eval.pair": 1, "pointdsc.eval.pad": 1, "pointdsc.model.forward": 1,
        "pointdsc.model.attention": 1}
    assert s["pointdsc.model.attention"]["device_s"] == pytest.approx(100e-6)
    assert s["pointdsc.model.forward"]["device_s"] == pytest.approx(40e-6)
    assert t["outside_device_s"] == pytest.approx(10e-6)
    assert t["device_s"] == pytest.approx(150e-6)
    assert t["busy_s"] == pytest.approx(150e-6) and t["window_s"] == pytest.approx(1200e-6)
    # gaps: [0, 420) mid 210 forward; [560, 1120) mid 840 pair; [1130, 1200) outside
    assert s["pointdsc.model.forward"]["idle_s"] == pytest.approx(420e-6)
    assert s["pointdsc.eval.pair"]["idle_s"] == pytest.approx(560e-6)
    assert t["outside_idle_s"] == pytest.approx(70e-6)
    assert s["pointdsc.eval.pair"]["host_s"] == pytest.approx(1000e-6)
    assert s["pointdsc.eval.pair"]["self_s"] == pytest.approx((1000 - 90 - 500) * 1e-6)
    assert s["pointdsc.model.forward"]["self_s"] == pytest.approx(400e-6)
    idle = sum(v["idle_s"] for v in s.values()) + t["outside_idle_s"]
    assert idle + t["busy_s"] == pytest.approx(t["window_s"])
    # a gap in the middle of the pad span, behind 1000 host events
    pad_gap = span_times(events + [ev_("k", 0, 30, device=True, id=1),
                                   ev_("k", 90, 420, device=True, id=2)],
                         window=(0, 420))["spans"]
    assert pad_gap["pointdsc.eval.pad"]["idle_s"] == pytest.approx(60e-6)


def test_span_times_without_spans():
    t = span_times([ev_("aten::add", 0, 10), ev_("k", 0, 5, device=True, id=1)])
    assert t["spans"] == {} and t["device_s"] == 0.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("offset_softmax", [False, True])
def test_spans_hold_the_device_time_on_card(dev, offset_softmax):
    """A traced pair at N = 5120 on the card: 99% or more of its device
    time was launched inside a program span, and the attention (running
    max) or the whole layers (offset softmax) carry device time."""
    model = load_pretrained(SNAP, device=dev, offset_softmax=offset_softmax)
    ev = Evaluator(model, fused_attention=True, device=dev)
    sample = SyntheticPairDataset(num_pairs=1, num_corr=5120, inlier_ratio=0.4, seed=0)[0]
    for _ in range(4):  # the probes and the warm-up
        ev.run_pair(sample)
    for _ in range(3):  # a profiler session may lose its device events (C14)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev.run_pair(sample)
            ev.run_pair(sample)
        t = span_times(prof.events())
        if t["device_s"] > 0:
            break
    assert t["device_s"] > 0
    assert t["outside_device_s"] < 0.01 * t["device_s"], t
    whole_layers = ev.model.offset_softmax  # unless the guard flipped
    inner = "pointdsc.model.layer" if whole_layers else "pointdsc.model.attention"
    assert t["spans"][inner]["n"] == 2 * 12
    assert t["spans"][inner]["device_s"] > 0.5 * t["device_s"]
