"""Card busy time of the model's forward, in ms a step: from the
``step.forward`` marker to the next (``step.backward``) in a training
step, from ``forward.model`` to ``forward.end`` in the served forward.
One reader for ``forward_ms.train`` and ``forward_ms.eval``."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    train = ctx["traffic"]["mode"] == "train"
    return phases.phase_ms(tr, "step.forward" if train else "forward.model")
