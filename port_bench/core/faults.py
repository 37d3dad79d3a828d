"""Faults planted under the timed path, for the check that ``correct``
catches them (``tests/test_port_bench_faults.py``, ``calibrate.py``).

A run whose ``Cell.fault`` names one plants it (:func:`planted`) while it
captures and drives its step. Each patches the program:

* ``unchanged_state``: AdamW's step does nothing, so the step returns its
  state unchanged;
* ``half_batch``: the loss leaves out the second half of the batch and
  takes the mean over the rest;
* ``scan_param_grads``: the scan backward (K2) returns half of its
  A, D and time-step-bias gradients, as a reduction of its partial sums
  that drops half of them would: a fault in a minority of leaves;
* ``altered_answer``: the served probabilities of the first image are
  rolled by one class where the forward produces them.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged_state():
    import torch
    return _patched(torch.optim.AdamW, "step", lambda self, closure=None:
                    None)


def half_batch():
    from medmamba_tpu_torch.train import trainer
    original = trainer.cross_entropy

    def first_half(logits, labels, group=None):
        keep = labels.clone()
        keep[labels.shape[0] // 2:] = -1
        return original(logits, keep, group)
    return _patched(trainer, "cross_entropy", first_half)


def scan_param_grads():
    from medmamba_tpu_torch.ops import scan_cuda
    original = scan_cuda.selective_scan_bwd

    def halved(*args, **kw):
        du, ddelta, dA, dB, dC, dD, dbias = original(*args, **kw)
        return (du, ddelta, dA * 0.5, dB, dC,
                None if dD is None else dD * 0.5,
                None if dbias is None else dbias * 0.5)
    return _patched(scan_cuda, "selective_scan_bwd", halved)


def altered_answer():
    from medmamba_tpu_torch.train import trainer
    original = trainer.predict

    def altered(model, images_u8, **kw):
        probs, x = original(model, images_u8, **kw)
        probs = probs.clone()
        probs[0] = probs[0].roll(1)
        return probs, x
    return _patched(trainer, "predict", altered)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "scan_param_grads": scan_param_grads,
          "altered_answer": altered_answer}
# the faults a cell of each traffic mode can have
BY_MODE = {"train": ("unchanged_state", "half_batch", "scan_param_grads"),
           "eval": ("altered_answer",)}


def planted(name):
    """The fault ``name`` planted, or nothing where ``name`` is None."""
    return contextlib.nullcontext() if name is None else FAULTS[name]()
