"""Card tests of the benchmark at the cells' own sizes: a short run of each
cell is correct, and the control and the answer fault each fail one of the
cell's limits. They skip without a CUDA card.

    python -m pytest benchmark/tests -q -m cuda
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (os.path.dirname(BENCH), BENCH):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from harness import cell as cells  # noqa: E402
from harness import compare  # noqa: E402

WORKLOADS = [w["name"] for w in cells.spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fails(numbers: dict, limits: dict) -> bool:
    return not all(within for _, _, within in compare.held(numbers, limits).values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card_is_correct(workload, card):
    import run

    out = run.run(workload, 424242, 2.0, False)
    assert out["correct"], out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_and_the_fault_fail_the_cell(workload, card):
    import control

    c = cells.cell(workload)
    for mode, numbers in control.eval_readings(c, 31337, ["control", "answer"], card).items():
        assert _fails(numbers, c.limits), (mode, numbers)
