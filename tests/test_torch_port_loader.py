"""The port's ``BatchLoader`` against the JAX package's: every error of a
dataset reaches the caller of ``epoch()``, ``BaseException``s included; the
process slices of data parallelism, ``pad_multiple`` and ``device_prefetch``
give the JAX loader's batches, bit for bit, in its order.

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
from medmamba_tpu.data.loader import device_prefetch as jax_device_prefetch
from medmamba_tpu_torch.data.loader import BatchLoader, device_prefetch

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


class _Indexed:
    """``n`` 4x4 images whose pixels are their index."""

    def __init__(self, n):
        self.images = (np.arange(n)[:, None, None, None]
                       * np.ones((n, 4, 4, 3))).astype(np.uint8)
        self.labels = np.arange(n, dtype=np.int64)

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx):
        return self.images[idx], self.labels[idx]


def _epochs(loader, epochs=(0, 1)):
    return [list(loader.epoch(e)) for e in epochs]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch)
        for (gi, gl), (wi, wl) in zip(g_epoch, w_epoch):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("n,batch", [(37, 8), (32, 8), (5, 8)])
def test_process_slices_match_the_jax_loader(n, batch):
    """Each of 4 processes yields the JAX loader's slice of every global
    batch, padding rows included, and the slices make up the one-process
    batch."""
    ds = _Indexed(n)
    for pi in range(4):
        kw = dict(shuffle=True, seed=7, process_index=pi, process_count=4)
        _same_batches(_epochs(BatchLoader(ds, batch, **kw)),
                      _epochs(JaxBatchLoader(ds, batch, **kw)))
    single = _epochs(BatchLoader(ds, batch, shuffle=True, seed=7))
    slices = [_epochs(BatchLoader(ds, batch, shuffle=True, seed=7,
                                  process_index=pi, process_count=4))
              for pi in range(4)]
    for e, batches in enumerate(single):
        for i, (img, lbl) in enumerate(batches):
            np.testing.assert_array_equal(
                np.concatenate([s[e][i][1] for s in slices]), lbl)
            real = lbl >= 0
            np.testing.assert_array_equal(
                np.concatenate([s[e][i][0] for s in slices])[real], img[real])


@pytest.mark.parametrize("pc", [1, 2])
def test_pad_multiple_matches_the_jax_loader(pc):
    ds = _Indexed(21)
    for pi in range(pc):
        kw = dict(shuffle=True, seed=3, pad_multiple=8, process_index=pi,
                  process_count=pc)
        port, jax_loader = BatchLoader(ds, 10, **kw), \
            JaxBatchLoader(ds, 10, **kw)
        assert port.padded_batch_size == jax_loader.padded_batch_size == 16
        _same_batches(_epochs(port), _epochs(jax_loader))
    assert BatchLoader(ds, 4, pad_multiple=8).padded_batch_size == 4


def test_all_padding_slice_is_masked():
    """A process whose whole slice of the final batch is padding still
    yields a full-shape batch, every label -1."""
    loaders = [BatchLoader(_Indexed(9), 8, shuffle=False, process_index=pi,
                           process_count=4) for pi in range(4)]
    finals = [list(ld.epoch(0))[-1] for ld in loaders]
    for pi, (img, lbl) in enumerate(finals):
        assert img.shape[0] == 2
        np.testing.assert_array_equal(lbl, [8, -1] if pi == 0 else [-1, -1])
        np.testing.assert_array_equal(img[:, 0, 0, 0], [8, 8])


def test_multi_process_loading_requires_pad_to_full():
    with pytest.raises(ValueError, match="pad_to_full"):
        BatchLoader(_Indexed(8), 4, pad_to_full=False, process_index=0,
                    process_count=2)
    with pytest.raises(ValueError, match="process_index"):
        BatchLoader(_Indexed(8), 4, process_index=2, process_count=2)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_order_and_depth_match_the_jax_one(depth):
    """On the CPU the port's ``device_prefetch`` puts and hands over
    batches in the JAX one's order: ``depth`` puts ahead of the consumer."""
    def trace(prefetch):
        events = []

        def items():
            for i in range(5):
                events.append(("read", i))
                yield (i,)

        def put(i):
            events.append(("put", i))
            return (i,)
        for (i,) in prefetch(items(), put, depth):
            events.append(("step", i))
        return events
    got = trace(device_prefetch)
    assert got == trace(jax_device_prefetch)
    assert [e for e in got if e[0] == "step"] == [("step", i)
                                                  for i in range(5)]
