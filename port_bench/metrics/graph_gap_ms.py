"""Card idle time inside the program's replayed steps, in ms a step: the
idle stretches between each replay's begin and end markers
(``core/phases.py``), where the card waits between the nodes of the
graph it replays. One reader for ``graph_gap_ms.train`` and
``graph_gap_ms.eval``."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    spans = [] if tr is None else phases.brackets(tr)
    if not spans:
        return None
    return phases.per_step_ms(tr, phases.idle_s(tr, spans))
