"""Card busy time of a language model's MLPs, in ms a step, forward plus
backward: the phases that the program's ``mlp.forward`` and
``mlp.backward`` markers open, each to the next marker
(``core/phases.py``). The last layer's forward phase runs on to
``step.backward``, so it holds the final norm, the LM head and the loss
too. None where the program has no such markers."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    parts = [phases.phase_ms(tr, f"mlp.{p}") for p in ("forward",
                                                        "backward")]
    return None if None in parts else sum(parts)
