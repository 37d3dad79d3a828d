"""Device time of the elementwise and copy kernels (the family of
``core/trace.py``) per training step or evaluated batch, in ms. One
reader for ``elementwise_ms.train`` and ``elementwise_ms.eval``."""


def read(ctx):
    tr = ctx.get("trace")
    t = None if tr is None else tr.per_step_s("elementwise/copy")
    return None if t is None else t * 1e3
