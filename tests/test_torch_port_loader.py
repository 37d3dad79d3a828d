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


def test_native_library_is_built_at_most_once_a_process(monkeypatch,
                                                        tmp_path):
    """Where the native library cannot be built, the NPZ gather falls back
    to numpy after one ``make``, not one ``make`` a batch."""
    import subprocess

    from medmamba_tpu_torch.data import native
    from medmamba_tpu_torch.data.datasets import NpzDataset

    calls, run = [], subprocess.run

    def failing_make(argv, *args, **kwargs):
        if argv[0] != "make":
            return run(argv, *args, **kwargs)
        calls.append(argv)
        raise subprocess.CalledProcessError(2, argv)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False, raising=False)
    monkeypatch.setattr(native, "_SO_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native.subprocess, "run", failing_make)
    rng = np.random.default_rng(0)
    np.save(tmp_path / "train_images.npy",
            rng.integers(0, 256, (10, 4, 4, 3), dtype=np.uint8))
    np.save(tmp_path / "train_labels.npy", np.arange(10).reshape(10, 1))
    ds = NpzDataset(str(tmp_path), "train")
    batches = list(BatchLoader(ds, 3, shuffle=False).epoch(0))
    assert len(batches) == 4 and len(calls) == 1
    np.testing.assert_array_equal(batches[1][0], ds.images[3:6])
