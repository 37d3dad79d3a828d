"""The benchmark's tests see the faults and controls of every traffic
mode: ``modes/extensions.py`` adds those of the modes that came after
``core/faults.py`` and ``core/control.py`` to their tables. A card test
of a cell that asks for more cards than the machine has skips, decided in
a fixture at run time."""
import pytest

from port_bench.core import harness
from port_bench.modes import extensions

extensions.register()
CHIPS = {w["name"]: w["chips"] for w in harness.load_benchmark()["workloads"]}


@pytest.fixture(autouse=True)
def _cards_for_the_cell(request):
    params = getattr(request.node, "callspec", None)
    workload = params.params.get("workload") if params else None
    if request.node.get_closest_marker("cuda") and workload in CHIPS:
        import torch
        if torch.cuda.device_count() < CHIPS[workload]:
            pytest.skip(f"{workload} needs {CHIPS[workload]} cards")
