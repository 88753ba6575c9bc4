"""CPU tests of the benchmark harness: finding a cell's pieces by name, the
traffic generators, the work formulas, the plain reference against the
program's dense path, a run at a small size with the timed path broken
underneath, the refusal without a card, and import isolation.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _path in (ROOT, BENCH):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from harness import cell as cells  # noqa: E402
from harness import compare, synthetic, work  # noqa: E402

SPEC = cells.spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
# a small size whose pairs keep enough inliers (30% and more of 200) for
# every hypothesis search to find the motion
SMALL_EVAL = {"config": {"model": {"num_layers": 2}},
              "traffic": {"pool": 6, "n_range": [200, 250], "bucket": 256, "warmup_pairs": 2,
                          "warmup_seconds": 0.0, "check_pairs": 3, "inlier_ratio": [0.3, 0.5]}}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------- finding pieces

@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_piece_of_a_cell_is_found_by_name(workload):
    c = cells.cell(workload)
    assert c.loop().__name__ == f"bench_loop_{c.traffic['loop']}"
    assert hasattr(c.reference(), "eval_forward")
    assert c.limits and all("limit" in v for v in c.limits.values())
    readers = c.metric_readers(False) + c.metric_readers(True)
    assert {m["name"] for m, _ in readers} == {
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]
        if "workloads" not in m or workload in m["workloads"]}
    assert all(callable(r.read) for _, r in readers)
    moved = {m["moves"] for m, _ in c.metric_readers(True)}
    assert moved <= {m["name"] for m, _ in c.metric_readers(False)}


def test_a_new_cell_is_added_by_new_files_only(tmp_path):
    """A configuration, a mix, a metric and a cell added as files to a copy of
    the benchmark are found by name; no file of the copy is edited but
    BENCHMARK.json."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = cells.spec()
    spec["configs"].append({"name": "wide", "source": "test", "file": "benchmark/configs/wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "wide.eval", "config": "wide", "traffic": "few_pairs",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "pairs_traced", "unit": "pairs", "better": "higher",
                              "source": "program_counter", "layer": "entry", "moves": "pair_ms",
                              "workloads": ["wide.eval"]})
    for m in spec["end_to_end"]:
        if m["name"] == "pair_ms":
            m["workloads"].append("wide.eval")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "pointdsc-3dmatch.json").read_text())
    (b / "configs" / "wide.json").write_text(json.dumps({**config, "tag": "wide"}))
    traffic = json.loads((b / "traffic" / "eval_redwood.json").read_text())
    (b / "traffic" / "few_pairs.json").write_text(json.dumps({**traffic, "pool": 3}))
    (b / "limits" / "wide.eval.json").write_text((b / "limits" / "redwood.eval.json").read_text())
    (b / "metrics" / "pairs_traced.py").write_text(
        "def read(record, cell):\n    return record.get('traced_items') or None\n")
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from harness import cell; "
            "c = cell.cell('wide.eval'); print(json.dumps([c.config['tag'], c.traffic['pool'], "
            "c.loop().__name__, [m['name'] for m, r in c.metric_readers(True)], "
            "[m['name'] for m, r in c.metric_readers(False)]]))")
    out = subprocess.run([sys.executable, "-c", code, str(b)], capture_output=True, text=True,
                         check=True, cwd=tmp_path)
    tag, pool, loop, layered, e2e = json.loads(out.stdout)
    assert (tag, pool, loop) == ("wide", 3, "bench_loop_eval_pairs")
    assert layered == ["pairs_traced"] and "pair_ms" in e2e and "setup_s" in e2e


# ---------------------------------------------------------------- traffic

@pytest.mark.parametrize("traffic", ["eval_redwood", "eval_kitti"])
def test_a_seed_gives_the_same_pool_and_another_seed_another(traffic):
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        t = json.load(f)
    t = {**t, "pool": 5, "n_range": [t["n_range"][0] // 20, t["n_range"][1] // 20]}
    big = 2**31 + 12345
    a, b, c = (synthetic.make_pool(t, s) for s in (big, big, 7))
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert any(not np.array_equal(x["src_keypts"], y["src_keypts"]) for x, y in zip(a, c))
    # the work does not depend on the seed: the same sizes, in another order
    assert sorted(p["corr_pos"].shape[0] for p in a) == sorted(p["corr_pos"].shape[0] for p in c)


def test_pool_plan_spans_the_ranges_and_only_the_seed_orders_it():
    plans = [synthetic.pool_plan(16, (100, 200), (0.1, 0.5), s) for s in (1, 2)]
    assert sorted(plans[0]) == sorted(plans[1]) and plans[0] != plans[1]
    ratios = sorted(r for _, r in plans[0])
    assert 0.1 < ratios[0] < 0.12 and 0.48 < ratios[-1] < 0.5
    assert len(set(ratios)) == 16


# ---------------------------------------------------------------- work formulas

def test_layer_and_encoder_work_by_hand():
    n, c = 4, 8
    dense, attn = work.layer_ops(n, c)
    # PointCN, Q, K, V: 4 x (2 n c c); the MLP 8 -> 4 -> 4 -> 8
    assert dense == 4 * 2 * n * c * c + 2 * n * (8 * 4 + 4 * 4 + 4 * 8)
    assert attn == 2 * (2 * n * n * c)
    prec = {"dense": "f32", "attention": "bf16"}
    assert work.encoder_seconds(n, c, 3, prec) == pytest.approx(
        3 * (dense / 67e12 + attn / 989e12))


def test_attention_work_by_hand():
    n, c = 6, 4
    prec = {"dense": "f32", "attention": "bf16"}
    # per layer q k^T and p v: 2 n n c multiply-adds each
    assert work.attention_seconds(n, c, 3, prec) == pytest.approx(3 * 4 * n * n * c / 989e12)


def test_eval_forward_work_by_hand():
    n, cfg = 10, {"num_channels": 8, "num_layers": 1, "in_dim": 6, "ratio": 0.2, "k": 3,
                  "num_iterations": 2}
    s = 2
    f32 = (n * (n + 1) / 2 * 23 + 2 * n * (6 * 8 + 8 * 32 + 32 * 32 + 32) + 2 * s * n * 8
           + s * (3 * 2 / 2 * 2 * 8 + 2 * 2 * 9) + s * n * 20)
    dense, attn = work.layer_ops(n, 8)
    prec = {"dense": "f32", "attention": "bf16"}
    assert work.eval_forward_seconds(n, cfg, prec) == pytest.approx(
        (f32 + dense) / 67e12 + attn / 989e12)


# ---------------------------------------------------------------- the reference

def _small_model_state(layers=2):
    from harness import checkpoint

    arrays = checkpoint.state_dict_arrays(
        os.path.join(ROOT, "snapshot/PointDSC_Synthetic_release/models/model_best.pkl"))
    loop = cells.cell("redwood.eval").loop()
    return {k: torch.from_numpy(v) for k, v in arrays.items() if loop._in_model(k, layers)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_agrees_with_the_program_dense_path(seed):
    from pointdsc_tpu_torch.models.pointdsc import PointDSC

    c = cells.cell("redwood.eval", overrides=SMALL_EVAL)
    ref = c.reference()
    sd = _small_model_state()
    model = PointDSC(**c.config["model"], device="cpu")
    model.load_state_dict(sd, strict=True)
    pair = synthetic.make_pool({**c.traffic, "pool": 3}, seed)[seed]
    padded = synthetic.pad(pair, 256)
    args = [torch.as_tensor(padded[k])[None] for k in ("corr_pos", "src_keypts", "tgt_keypts",
                                                          "mask")]
    with torch.no_grad():
        out = model(*args[:3], mask=args[3], testing=True, fused=False)
    r = ref.eval_forward(sd, pair, c.config["model"], 256, "cpu")
    n = pair["corr_pos"].shape[0]
    np.testing.assert_allclose(out.confidence[0, :n].numpy(), r["confidence"], atol=2e-5)
    np.testing.assert_allclose(out.final_trans[0].numpy(), r["trans"], atol=1e-5)
    np.testing.assert_array_equal(out.final_labels[0, :n].numpy(), r["labels"])


# ---------------------------------------------------------------- runs with faults

def _run(workload, **kw):
    import run

    return run.run(workload, 5, 0.5, False, device="cpu", overrides=SMALL_EVAL, **kw)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_small_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cells.cell(workload).end_to_end}
    # the worst pair of each number is named, and the median pair's gap held
    assert {"conf_rms", "pose_gap"} <= set(out["info"]["worst"])
    assert set(out["check"]) == {"conf_rms_median", "pose_gap"}


def _eval_answer_altered(monkeypatch):
    """The final transform moved by one inlier threshold where the model
    produces it."""
    from pointdsc_tpu_torch.models.pointdsc import PointDSC

    forward = PointDSC.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        trans = out.final_trans.clone()
        trans[:, 0, 3] += self.inlier_threshold
        return out._replace(final_trans=trans)
    monkeypatch.setattr(PointDSC, "forward", altered)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_with_the_timed_path_broken_is_not_correct(workload, monkeypatch):
    _eval_answer_altered(monkeypatch)
    out = _run(workload)
    assert not out["correct"], out["check"]


def test_the_check_holds_every_number_to_its_limit():
    held = compare.held({"a": 1.0, "b": 3.0, "c": 9.0}, {"a": {"limit": 2.0}, "b": {"limit": 2.0}})
    assert held == {"a": (1.0, 2.0, True), "b": (3.0, 2.0, False)}


# ---------------------------------------------------------------- process level

def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


_ISOLATION = """
import glob, os, sys
bench = sys.argv[1]
sys.path[:0] = [os.path.dirname(bench), bench]
{body}
bad = sorted({{m for m in sys.modules if m.split('.')[0] in {forbidden}}})
print(','.join(bad))
"""


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    body = ("import run\nfrom harness import cell\n"
            "for w in cell.spec()['workloads']:\n"
            "    c = cell.cell(w['name']); c.loop(); c.reference()\n"
            "    c.metric_readers(True); c.metric_readers(False)\n"
            "import control\n"
            "import pointdsc_tpu_torch.eval.runner")
    code = _ISOLATION.format(body=body, forbidden=("jax", "jaxlib", "flax", "pointdsc_tpu"))
    out = subprocess.run([sys.executable, "-c", code, BENCH], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == ""


def test_the_reference_loads_nothing_of_the_program():
    body = "import reference.pointdsc"
    code = _ISOLATION.format(body=body, forbidden=("jax", "jaxlib", "flax", "pointdsc_tpu",
                                                   "pointdsc_tpu_torch"))
    out = subprocess.run([sys.executable, "-c", code, BENCH], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == ""
