"""The scan backward kernels' share of their roofline, in percent: the
least time the card could take for a step's scan backwards (each launch's
bytes read once and written once, or its FLOPs at the float32 peak,
whichever bounds it; ``core/work.py: scan_launches``) over the device time
of the kernels of the ``scan_bwd`` family per step."""
from port_bench.core import work


def read(ctx):
    tr = ctx.get("trace")
    t = None if tr is None else tr.per_step_s("scan_bwd")
    if t is None:
        return None
    launches = work.scan_launches(ctx["config"],
                                  ctx["batch"] // ctx["chips"],
                                  ctx["block_dtype"])
    bound = sum(work.bound_s(x["bwd_flops"], x["bwd_bytes"],
                             work.PEAK_FLOPS["float32"]) for x in launches)
    return 100.0 * bound / t
