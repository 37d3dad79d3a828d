"""Device time of the host-to-card copies per evaluated batch, in ms."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    lo, hi = tr.window
    t = sum(min(e, hi) - max(s, lo) for n, s, e in tr.device
            if "HtoD" in n and e > lo and s < hi)
    return t / tr.steps * 1e3 if t > 0 else None
