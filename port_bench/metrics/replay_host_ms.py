"""Host time of the program's compiled-step calls, in ms a step: its
``medmamba.graph.call`` spans (the signature, the graph lookup, the state
guard, the copy into the static inputs and the graph launch). One reader
for ``replay_host_ms.train`` and ``replay_host_ms.eval``."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else phases.per_step_ms(
        tr, phases.span_s(tr, "graph.call"))
