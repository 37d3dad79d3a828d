"""Card busy time of a language model's Mamba mixers, in ms a step,
forward plus backward: the phases that the program's ``mixer.forward``
and ``mixer.backward`` markers open, each to the next marker
(``core/phases.py``). None where the program has no such markers."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    parts = [phases.phase_ms(tr, f"mixer.{p}") for p in ("forward",
                                                          "backward")]
    return None if None in parts else sum(parts)
