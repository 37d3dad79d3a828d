"""Card idle time between the program's replayed steps, in ms a step: the
idle stretches of the window outside every replay's begin and end
markers (``core/phases.py``), where the card waits on the host's replay
path (the state guard, the copy into the static inputs, the graph launch,
the loss or probability read). With ``graph_gap_ms`` it makes up the
window's idle time. One reader for ``launch_gap_ms.train`` and
``launch_gap_ms.eval``."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    spans = [] if tr is None else phases.brackets(tr)
    if not spans:
        return None
    return phases.per_step_ms(tr, phases.idle_s(tr,
                                                phases.outside(tr, spans)))
