"""Nodes of the CUDA graph of the cell's step, as the program's gauge
``graph.nodes.<label>`` holds it after capture (``train step`` for the
training traffic, ``forward`` for the served forward). One reader for
``graph_nodes.train`` and ``graph_nodes.eval``; None where the program
keeps no such gauge."""


def read(ctx):
    try:
        from medmamba_tpu_torch.utils import tracing
    except ImportError:
        return None
    label = "train step" if ctx["traffic"]["mode"] == "train" else "forward"
    return tracing.snapshot()["counters"].get(f"graph.nodes.{label}")
