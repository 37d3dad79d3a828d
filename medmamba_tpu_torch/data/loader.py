"""Host-side batch loader with background prefetch (a copy of
``medmamba_tpu/data/loader.py`` for the PyTorch port).

A background thread gathers (and, in folder mode, decodes) batch N+1 while
the caller runs batch N. The final partial batch is padded to the full batch
size with label -1, so every batch has one shape; callers mask label < 0.
Under data parallelism each process yields its contiguous slice of every
global batch (``process_index``/``process_count``), and
:func:`device_prefetch` moves batches to the device ahead of the step.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Tuple

import numpy as np
import torch


def device_prefetch(iterator: Iterator, put_fn: Callable, depth: int = 2,
                    device=None):
    """Yield device-resident batches, transferring ``depth`` batches ahead.

    ``put_fn(*host_batch)`` makes the host-to-device copy (e.g.
    ``parallel.mesh.shard_batch``) and returns a tuple of tensors. With
    ``device`` a CUDA device, each ``put_fn`` runs on a side stream (its
    copies come from pinned memory) and a batch is handed over only once
    the caller's current stream waits on the copy's event; its tensors are
    marked as used by that stream, so their memory is not reused while the
    step still reads them. A graphed step's copy into its static inputs
    then reads finished data. Otherwise ``put_fn`` runs where it is called,
    as in the JAX package.
    """
    cuda = device is not None and torch.device(device).type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def put(item):
        if not cuda:
            return put_fn(*item), None
        with torch.cuda.stream(side):
            out = put_fn(*item)
        done = torch.cuda.Event()
        done.record(side)
        return out, done

    def hand(entry):
        out, done = entry
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for t in out:
                t.record_stream(stream)
        return out

    buf = collections.deque()
    for item in iterator:
        buf.append(put(item))
        if len(buf) >= depth:
            yield hand(buf.popleft())
    while buf:
        yield hand(buf.popleft())


class BatchLoader:
    """Deterministic, seeded, shuffling batch iterator over a dataset.

    dataset must provide ``__len__`` and ``get_batch(idx) -> (images_u8, labels)``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 42, drop_last: bool = False,
                 prefetch: int = 2, pad_to_full: bool = True,
                 pad_multiple: int = 1, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        # Data parallelism: with ``process_count`` > 1 every process builds
        # the SAME seeded global shuffle, then yields only its contiguous
        # 1/process_count slice of each global batch. batch_size stays the
        # GLOBAL batch, so recipes do not depend on the process count.
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"[0, {process_count})")
        if process_count > 1 and not pad_to_full:
            raise ValueError("multi-process loading requires pad_to_full "
                             "(every process must yield the same static "
                             "local shape)")
        self.process_index = process_index
        self.process_count = process_count
        self.pad_to_full = pad_to_full
        # Optionally round EVERY batch up to a multiple of ``pad_multiple``;
        # the padded rows carry label -1 and contribute nothing (masked loss
        # and BatchNorm statistics)
        self.pad_multiple = (max(1, pad_multiple)
                             if pad_to_full and batch_size >= pad_multiple
                             else 1)

    @property
    def padded_batch_size(self) -> int:
        m = self.pad_multiple
        return -(-self.batch_size // m) * m

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(n)

    def _materialize(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch this process's slice of one GLOBAL batch (indices ``idx``),
        padded rows (the last image repeated, label -1) included.

        One process: the whole batch, padded to ``padded_batch_size`` when
        ``pad_to_full``. Several: global rows [pi*lb, (pi+1)*lb) of the
        padded global batch, lb = padded/count; every process fetches only
        its own rows."""
        target = self.padded_batch_size if self.pad_to_full else len(idx)
        pc, pi = self.process_count, self.process_index
        if target % pc:
            raise ValueError(f"batch {target} does not divide over {pc} "
                             "processes")
        lb = target // pc
        lo = pi * lb
        real = idx[lo:min(lo + lb, len(idx))]
        if len(real) == 0:
            # the entire local slice is padding (a tiny final batch): the
            # batch's last real example repeated, every row label -1
            imgs, labels = self.dataset.get_batch(idx[-1:])
            imgs = np.repeat(imgs, lb, 0)
            labels = np.full((lb,), -1, labels.dtype)
            return imgs, labels
        imgs, labels = self.dataset.get_batch(real)
        if len(real) < lb:
            pad = lb - len(real)
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)], 0)
            labels = np.concatenate(
                [labels, np.full((pad,), -1, labels.dtype)], 0)
        return imgs, labels

    def epoch(self, epoch_idx: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._order(epoch_idx)
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checking_stop(item) -> bool:
            # a plain q.put can block forever if the consumer abandoned the
            # generator (stop is only observable between puts); poll instead
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for i in range(nb):
                    if stop.is_set():
                        return
                    idx = order[i * self.batch_size:(i + 1) * self.batch_size]
                    if not put_checking_stop(self._materialize(idx)):
                        return
            except BaseException as e:  # surfaced to the consumer below
                put_checking_stop(e)
            else:
                put_checking_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
