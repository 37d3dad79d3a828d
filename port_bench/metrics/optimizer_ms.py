"""Card busy time of a training step's AdamW, in ms a step: from the
``step.optimizer`` marker to ``step.end``."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else phases.phase_ms(tr, "step.optimizer")
