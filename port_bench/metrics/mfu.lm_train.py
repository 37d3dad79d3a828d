"""A language-model training step's share of the card's peak, in percent:
the benchmark's FLOPs of a step (``core/work_lm.py``: 2 per MAC, the LM
head and causal attention counted, the step as three forwards) over the
traced window, against the bfloat16 peak (989 TFLOP/s) times the cards
used."""
from port_bench.core import work, work_lm


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    flops = work_lm.step_flops(ctx["config"], ctx["batch"], ctx["seq_len"])
    peak = work.PEAK_FLOPS[ctx["block_dtype"]] * ctx["chips"]
    return 100.0 * flops * tr.steps / tr.window_s / peak
