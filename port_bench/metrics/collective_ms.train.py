"""Device time of the NCCL kernels (the ``collective`` family of
``core/trace.py``) on one card, in ms a step: the gradient all-reduce and
the global BatchNorm sums of a data-parallel step, as the traced rank's
card runs them. None where no collective ran."""


def read(ctx):
    tr = ctx.get("trace")
    t = None if tr is None else tr.per_step_s("collective")
    return None if t is None else t * 1e3
