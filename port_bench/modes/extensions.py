"""Not a traffic mode: the planted faults and the controls of the traffic
modes added after ``core/faults.py`` and ``core/control.py``:
``lm_train`` (``modes/lm_train.py``) and ``train_dp``
(``modes/train_dp.py``). They patch the program, so they live beside the
modes and not in ``core/``, which imports nothing of it but the faults
and the harness.

:func:`register` adds them to those modules' tables (``faults.FAULTS``,
``faults.BY_MODE``, ``control.READINGS``), so the card tests
(``tests/conftest.py`` registers them) and ``calibrate_all.py`` see every
mode's; :func:`planted` plants a fault of either table.

Faults, each patching the program:

* ``acausal_attention``: attention without its causal mask;
* ``no_skip_d``: the Mamba mixers' scan without its D u term;
* ``no_dbc_norms``: the mixers' dt, B and C without their RMSNorms;
* ``scan_bf16``: the scan in the kernels' bfloat16 compute mode
  (``MEDMAMBA_SCAN_COMPUTE=bfloat16``), where the cell states float32;
* ``no_exchange``: data-parallel ranks step without the gradient
  all-reduce, each on its own rows' part of the gradient.

Controls: ``lm_train``'s is the Jamba reference in float8 training's
rounding (``reference/vssm.py: FP8``) against the float32 reference, as
``core/control.py`` does for the VSSM; ``train_dp``'s is the VSSM
training control at the global batch.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch

from port_bench.core import check_lm, control, faults
from port_bench.modes import common


def acausal_attention():
    import torch.nn.functional as F
    original = F.scaled_dot_product_attention

    def acausal(*args, **kw):
        kw["is_causal"] = False
        return original(*args, **kw)
    return faults._patched(F, "scaled_dot_product_attention", acausal)


def no_skip_d():
    from medmamba_tpu_torch.models import jamba
    original = jamba.selective_scan

    def without_d(u, delta, A, B, C, D=None, *args, **kw):
        return original(u, delta, A, B, C, None, *args, **kw)
    return faults._patched(jamba, "selective_scan", without_d)


def no_dbc_norms():
    from medmamba_tpu_torch.models import jamba
    original = jamba.RMSNorm.forward

    def skipped(self, x, dtype, dim=-1):
        # the mixers' dt, B and C norms are the ones over dim 1
        return x.to(dtype) if dim == 1 else original(self, x, dtype, dim)
    return faults._patched(jamba.RMSNorm, "forward", skipped)


@contextlib.contextmanager
def scan_bf16():
    saved = os.environ.get("MEDMAMBA_SCAN_COMPUTE")
    os.environ["MEDMAMBA_SCAN_COMPUTE"] = "bfloat16"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["MEDMAMBA_SCAN_COMPUTE"]
        else:
            os.environ["MEDMAMBA_SCAN_COMPUTE"] = saved


def no_exchange():
    from medmamba_tpu_torch.train import trainer
    return faults._patched(trainer, "sum_grads",
                           lambda params, loss, group: loss)


FAULTS = {"acausal_attention": acausal_attention, "no_skip_d": no_skip_d,
          "no_dbc_norms": no_dbc_norms, "scan_bf16": scan_bf16,
          "no_exchange": no_exchange}
BY_MODE = {"lm_train": ("acausal_attention", "no_skip_d", "no_dbc_norms",
                        "scan_bf16"),
           "train_dp": ("no_exchange",)}


def planted(name):
    """The fault ``name`` (of this module or ``core/faults.py``) planted,
    or nothing where ``name`` is None."""
    if name is None:
        return contextlib.nullcontext()
    return {**faults.FAULTS, **FAULTS}[name]()


def lm_batches(cfg: dict, tr: dict, seed: int, device) -> torch.Tensor:
    """The pool of a language-model cell: ``traffic["pool"]`` distinct
    batches of (batch, seq_len) token ids, uniform over the vocabulary,
    drawn on the card from the data seed of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(
        common.sub_seeds(seed)["data"])
    return torch.randint(0, cfg["vocab_size"],
                         (tr["pool"], tr["batch"], tr["seq_len"]),
                         generator=gen, device=device)


def lm_reference(cfg: dict, tr: dict, seed: int, device,
                 quant=None) -> dict:
    """The reference's first ``check_steps`` steps from the cell's
    weights and batches: ``losses``, and the first gradient's and the
    parameters' changes' norms by leaf (``check_lm.norms``)."""
    from port_bench.reference import jamba as ref
    weights = ref.make_weights(cfg, common.sub_seeds(seed)["weights"],
                               device)
    ids = lm_batches(cfg, tr, seed, device)
    losses, grads, params = ref.train_steps(
        weights, list(ids[:tr["check_steps"]]), cfg, lr=tr["lr"],
        weight_decay=tr["weight_decay"], quant=quant)
    out = dict(losses=losses, grads=check_lm.norms(grads),
               change={n: check_lm.norm(params[n] - weights[n])
                       for n in params})
    del grads, params, weights
    torch.cuda.empty_cache()
    return out


def lm_readings(cfg: dict, tr: dict, seed: int, device,
                leaves: bool = False) -> Dict[str, float]:
    """The control's numbers: the reference in float8 training's rounding
    against the float32 reference (``leaves`` has nothing to add)."""
    from port_bench.reference.vssm import FP8
    want = lm_reference(cfg, tr, seed, device)
    got = lm_reference(cfg, tr, seed, device, quant=FP8)
    return check_lm.train_checks(got, want)


READINGS = {"lm_train": lm_readings, "train_dp": control.train_readings}


def register() -> None:
    """Add this module's faults and controls to ``core/faults.py``'s and
    ``core/control.py``'s tables."""
    faults.FAULTS.update(FAULTS)
    faults.BY_MODE.update(BY_MODE)
    control.READINGS.update(READINGS)
