"""The port's ``BatchLoader`` hands every error of a dataset to the caller of
``epoch()``, as the JAX package's does, ``BaseException``s included.

A dataset whose ``get_batch`` raises kills the loader's producer thread; the
loader must put the error on its queue so that the consumer raises it
instead of waiting on the queue forever. Each case runs the epoch in a
daemon thread joined with a timeout, so that a regression fails here
instead of hanging the suite.
"""
import threading

import numpy as np
import pytest

from medmamba_tpu.data.loader import BatchLoader as JaxBatchLoader
from medmamba_tpu_torch.data.loader import BatchLoader

TIMEOUT_S = 10.0


class _Raising:
    """Ten one-pixel images; ``get_batch`` raises ``exc`` from the batch
    holding index ``at`` on."""

    def __init__(self, exc, at=5):
        self.exc = exc
        self.at = at

    def __len__(self):
        return 10

    def get_batch(self, idx):
        if max(idx) >= self.at:
            raise self.exc("dataset failed")
        return np.zeros((len(idx), 1, 1, 3), np.uint8), np.zeros(len(idx))


def _drain(loader_cls, dataset):
    """Run one epoch in a daemon thread; returns (batches seen, the error
    the epoch raised or None, whether the thread ended in time)."""
    seen, raised = [], []

    def consume():
        try:
            for batch in loader_cls(dataset, 4, shuffle=False).epoch(0):
                seen.append(batch)
        except BaseException as e:   # the error under test, whatever kind
            raised.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    return seen, (raised[0] if raised else None), not t.is_alive()


@pytest.mark.parametrize("loader", ["port", "jax"])
@pytest.mark.parametrize("exc", [SystemExit, KeyboardInterrupt, ValueError])
def test_epoch_raises_the_datasets_error(loader, exc):
    """The batch before the failing one arrives, then ``epoch()`` raises the
    dataset's error itself, of its own class, within the timeout."""
    cls = BatchLoader if loader == "port" else JaxBatchLoader
    seen, raised, ended = _drain(cls, _Raising(exc))
    assert ended, f"epoch() still blocked after {TIMEOUT_S} s"
    assert type(raised) is exc and str(raised) == "dataset failed"
    assert len(seen) == 1 and seen[0][0].shape == (4, 1, 1, 3)
