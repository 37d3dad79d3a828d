"""Set-up seconds spent capturing the program's graphs: the total of its
``graph.capture`` spans (warm-up, capture, restore) over the run; None
where the program keeps no such span."""


def read(ctx):
    try:
        from medmamba_tpu_torch.utils import tracing
    except ImportError:
        return None
    total = tracing.snapshot()["spans"].get("graph.capture")
    return None if total is None else total["s"]
