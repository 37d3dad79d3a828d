"""The scan backward kernels' share of their roofline in a language-model
training step, in percent: the least time the card could take for the
step's K2 launches, one a Mamba mixer (``core/work_lm.py:
scan_bound_s``), over the device time of the ``scan_bwd`` family (the
walk and its reduction) per step."""
from port_bench.core import work_lm


def read(ctx):
    tr = ctx.get("trace")
    t = None if tr is None else tr.per_step_s("scan_bwd")
    if t is None:
        return None
    return 100.0 * work_lm.scan_bound_s(ctx["config"], ctx["batch"],
                                        ctx["seq_len"], ctx["block_dtype"],
                                        "bwd") / t
