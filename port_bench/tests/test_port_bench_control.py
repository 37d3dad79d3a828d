"""The control of each cell (``core/control.py``: the reference in the
nearest precision below the cell's, in the program's place) fails the
cell's comparison on three seeds, at the cell's own size. Needs the card:

    python -m pytest port_bench/tests -m cuda -q
"""
import pytest

from port_bench.core import control, harness

pytestmark = pytest.mark.cuda
BENCH = harness.load_benchmark()
SEEDS = (2147483911, 2147483912, 2147483913)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from port_bench.modes import common
    return common.card()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_the_comparison(card, workload, seed):
    _, config, traffic, limits = harness.resolve(BENCH, workload)
    got = control.READINGS[traffic["mode"]](config, traffic, seed, card)
    assert any(got[n] > limits[n] for n in limits), (got, limits)
