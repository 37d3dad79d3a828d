"""Card busy time of a language model's attention layers, in ms a step,
forward plus backward: the phases that the program's ``attention.forward``
and ``attention.backward`` markers open, each to the next marker
(``core/phases.py``). None where the program has no such markers."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    parts = [phases.phase_ms(tr, f"attention.{p}") for p in ("forward",
                                                              "backward")]
    return None if None in parts else sum(parts)
