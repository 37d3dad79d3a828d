"""The selective scan as graph ops: ``torch.library`` custom ops.

``torch.export`` cannot trace into the scan kernels' wrappers (they hand
``data_ptr()``s to a ctypes call) and would unroll the plain scan's loop
over L into L steps. Each scan call of an inference forward is therefore
one op of the ``medmamba`` namespace, which an exported graph holds as one
node and which dispatches by device when it runs:

- ``medmamba::selective_scan_fwd``: on CUDA tensors K1
  (``scan_cuda.selective_scan_fwd``); on CPU tensors the plain version, the
  CPU branch of ``ops.selective_scan``;
- ``medmamba::selective_scan_hillis_fwd``: on CUDA tensors the forward of
  ``selective_scan._hillis_scan``, reverse groups flipped around K3
  (``scan_hillis.selective_scan_hillis_fwd``), y float32. It has no CPU
  kernel: the hillis scan is chosen only for a CUDA tensor.

Both take the call-site contract of ``ops.selective_scan`` (without tau,
which it ignores) and its compute mode as ``compute`` ("float32", the
default, or "bfloat16"; the CPU kernel runs the plain version in that mode),
and return a list: ``[y]``, or ``[y, last]`` with
``return_last_state``, y (b, KD, L) and last (b, KD, N) float32. The mode
is an argument of the node, so an exported graph keeps the mode it was
traced under whatever ``MEDMAMBA_SCAN_COMPUTE`` says when it runs. The fake
kernels give those shapes without running anything, so the kernels' launch
counts move only when a kernel runs. Neither op has a backward: gradients
go through ``_KernelScan`` and ``_HillisScan``, and ``ops.selective_scan``
calls an op only where no gradient is needed.

The ops are defined with ``torch.library.Library`` rather than
``torch.library.custom_op``, whose Python autograd wrapper would add host
time to every scan of the live path. Importing this module registers them;
a loaded artifact needs that before it runs.
"""
from __future__ import annotations

import torch

from medmamba_tpu_torch.ops import scan_cuda, scan_hillis
from medmamba_tpu_torch.ops import selective_scan as ss

_ARGS = ("Tensor u, Tensor delta, Tensor A, Tensor B, Tensor C, Tensor? D, "
         "Tensor? delta_bias, bool delta_softplus, bool return_last_state, "
         "bool[]? reverse_dirs, int u_tile, ScalarType? out_dtype, "
         "int? valid_len, str compute='float32'")

_LIB = torch.library.Library("medmamba", "DEF")
_LIB.define(f"selective_scan_fwd({_ARGS}) -> Tensor[]")
_LIB.define(f"selective_scan_hillis_fwd({_ARGS}) -> Tensor[]")

selective_scan_fwd = torch.ops.medmamba.selective_scan_fwd.default
selective_scan_hillis_fwd = (
    torch.ops.medmamba.selective_scan_hillis_fwd.default)


def _fwd_cpu(u, delta, A, B, C, D, delta_bias, delta_softplus,
             return_last_state, reverse_dirs, u_tile, out_dtype, valid_len,
             compute="float32"):
    out = ss._plain_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                         return_last_state, reverse_dirs, u_tile, out_dtype,
                         valid_len, compute)
    return list(out) if return_last_state else [out]


def _fwd_cuda(u, delta, A, B, C, D, delta_bias, delta_softplus,
              return_last_state, reverse_dirs, u_tile, out_dtype, valid_len,
              compute="float32"):
    y, last, _ = scan_cuda.selective_scan_fwd(
        u, delta, A, B, C, D, delta_bias, delta_softplus=delta_softplus,
        reverse_dirs=reverse_dirs, u_tile=u_tile, out_dtype=out_dtype,
        valid_len=valid_len, return_last_state=return_last_state,
        compute=compute)
    return [y, last] if return_last_state else [y]


def _hillis_fwd_cuda(u, delta, A, B, C, D, delta_bias, delta_softplus,
                     return_last_state, reverse_dirs, u_tile, out_dtype,
                     valid_len, compute="float32"):
    y, last = ss._hillis_scan(
        u, delta, A, B, C, D, delta_bias, delta_softplus, True, reverse_dirs,
        u_tile, valid_len, scan_hillis.selective_scan_hillis_fwd,
        scan_hillis.selective_scan_hillis_bwd, compute)
    return [y, last] if return_last_state else [y]


def _fake(y_dtype):
    def fake(u, delta, A, B, C, D, delta_bias, delta_softplus,
             return_last_state, reverse_dirs, u_tile, out_dtype, valid_len,
             compute="float32"):
        y = delta.new_empty(delta.shape, dtype=y_dtype or out_dtype
                            or torch.float32)
        if not return_last_state:
            return [y]
        return [y, delta.new_empty((delta.shape[0], delta.shape[1],
                                    A.shape[1]), dtype=torch.float32)]
    return fake


_LIB.impl("selective_scan_fwd", _fwd_cpu, "CPU")
_LIB.impl("selective_scan_fwd", _fwd_cuda, "CUDA")
_LIB.impl("selective_scan_hillis_fwd", _hillis_fwd_cuda, "CUDA")
torch.library.register_fake("medmamba::selective_scan_fwd", _fake(None),
                            lib=_LIB)
torch.library.register_fake("medmamba::selective_scan_hillis_fwd",
                            _fake(torch.float32), lib=_LIB)
