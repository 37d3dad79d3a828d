"""The whole step's share of the cards' peak, in percent: the benchmark's
FLOPs of a step (2 per MAC; a training step's forward and backward
counted as three forwards, by the traffic's ``mode``) over the traced
window, against the peak of the configuration's block dtype (bfloat16:
989 TFLOP/s; float32 without TF32: 67) times the cards used. One reader
for ``mfu.train`` and ``mfu.eval``."""
from port_bench.core import work


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    flops = work.step_flops(ctx["config"], ctx["batch"],
                            train=ctx["traffic"]["mode"] == "train")
    peak = work.PEAK_FLOPS[ctx["block_dtype"]] * ctx["chips"]
    return 100.0 * flops * tr.steps / tr.window_s / peak
