"""``correct`` comes out false when the timed path is broken underneath:
each fault of ``core/faults.py`` that a cell's traffic can have, planted
in the program while a run (its look for a card skipped) captures and
drives its step at the cell's own size. Needs the card:

    python -m pytest port_bench/tests -m cuda -q
"""
import time

import pytest

from port_bench.core import faults, harness

pytestmark = pytest.mark.cuda
BENCH = harness.load_benchmark()
CASES = [(w["name"], f) for w in BENCH["workloads"]
         for f in faults.BY_MODE[harness.resolve(BENCH, w["name"])[2]
                                 ["mode"]]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_makes_the_run_incorrect(card, workload, fault):
    w, config, traffic, limits = harness.resolve(BENCH, workload)
    cell = harness.Cell(workload, config, traffic, limits, w["chips"],
                        2147483901, 1.0, False, time.time(), fault)
    out = harness.run_cell(cell)
    line = harness.result_line(BENCH, cell, out)
    assert not line["correct"], line["checks"]
