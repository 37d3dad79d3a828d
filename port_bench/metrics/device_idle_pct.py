"""Share of the traced window in which nothing ran on the card (no kernel,
no copy), in percent. One reader for ``device_idle_pct.train`` and
``device_idle_pct.eval``."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
