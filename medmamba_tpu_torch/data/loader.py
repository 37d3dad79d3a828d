"""Host-side batch loader with background prefetch (a copy of
``medmamba_tpu/data/loader.py``'s ``BatchLoader`` for the PyTorch port).

A background thread gathers (and, in folder mode, decodes) batch N+1 while
the caller runs batch N. The final partial batch is padded to the full batch
size with label -1, so every batch has one shape; callers mask label < 0.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


class BatchLoader:
    """Deterministic, seeded, shuffling batch iterator over a dataset.

    dataset must provide ``__len__`` and ``get_batch(idx) -> (images_u8, labels)``.
    (The JAX copy's multi-process slicing and ``pad_multiple`` come with
    the port's distribution and training slices.)
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 42, drop_last: bool = False,
                 prefetch: int = 2, pad_to_full: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_to_full = pad_to_full

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
        """One batch (indices ``idx``), padded to the full batch size when
        ``pad_to_full``: the last image repeated, label -1."""
        imgs, labels = self.dataset.get_batch(idx)
        pad = self.batch_size - len(idx) if self.pad_to_full else 0
        if pad > 0:
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
