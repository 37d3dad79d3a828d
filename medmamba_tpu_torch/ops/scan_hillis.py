"""The selective-scan kernels K3 (forward) and K4 (backward) on Hopper.

Counterparts of ``medmamba_tpu/ops/pallas_scan.py``'s ``_fwd_kernel`` and
``_bwd_kernel``, the doubling scan that ``MEDMAMBA_SCAN_KERNEL=hillis``
selects. The kernels are ``csrc/selective_scan_hillis_fwd.cu`` and
``csrc/selective_scan_hillis_bwd.cu``, built and loaded by
``ops/cuda_build.py`` on first launch. Neither doubles: K3 runs K1's
sequential walk (``csrc/scan_fwd_walk.cuh``) and saves the state entering
each ``CHUNK``-step chunk; K4 expands them to the states entering each of
K2's ``scan_cuda.TILE``-step tiles and runs K2's sequential adjoint
(``csrc/scan_bwd_walk.cuh``) from there: three kernels a launch. Both scan
left to right only; ``ops.selective_scan`` flips reverse groups and tiles a
shared u around them, as the JAX package's wrapper does.

Both take the compute mode of ``ops.selective_scan`` as ``compute``; in the
bfloat16 mode they also carry the state h and the adjoint dh in bfloat16,
as the TPU kernels do.

``HILLIS_LAUNCHES`` counts K3 launches made through
:func:`selective_scan_hillis_fwd` and ``HILLIS_BWD_LAUNCHES`` K4 launches
made through :func:`selective_scan_hillis_bwd`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from medmamba_tpu_torch.ops import cuda_build, scan_cuda

FWD_SOURCE = "selective_scan_hillis_fwd.cu"
BWD_SOURCE = "selective_scan_hillis_bwd.cu"
N_STATE = scan_cuda.N_STATE
CHUNK = 128        # the TPU kernel's chunk: K3 saves one state per chunk

HILLIS_LAUNCHES = 0
HILLIS_BWD_LAUNCHES = 0


def _declare_fwd(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_selective_scan_hillis_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_selective_scan_hillis_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.medmamba_selective_scan_hillis_bwd_workspace
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong


def n_chunks(l: int) -> int:
    return -(-l // CHUNK)


def selective_scan_hillis_fwd(u: torch.Tensor, delta: torch.Tensor,
                              A: torch.Tensor, B: torch.Tensor,
                              C: torch.Tensor,
                              D: Optional[torch.Tensor] = None,
                              delta_bias: Optional[torch.Tensor] = None, *,
                              delta_softplus: bool = False,
                              valid_len: Optional[int] = None,
                              compute: str = "float32"):
    """Launch K3 on CUDA tensors: the scan left to right over every group,
    in the compute mode ``compute``.

    Returns ``(y, states, last)``, all float32: y (b, G*dpg, L) whatever the
    input type (the TPU kernel stores float32 too), the state entering each
    ``CHUNK``-step chunk (b, G*dpg, n_chunks, 16) (K4's input), and the state
    after the last step (b, G*dpg, 16). Positions >= ``valid_len`` are
    identity steps (dt = 0). Raises on anything the kernel does not take, and
    when a gradient is required: differentiable calls go through
    ``ops.selective_scan``, whose backward is K4.
    """
    global HILLIS_LAUNCHES
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (u, delta, A, B, C, D, delta_bias)):
        raise RuntimeError("selective_scan_hillis_fwd has no backward of its "
                           "own; call medmamba_tpu_torch.ops.selective_scan")
    # the operands of K1 with one u group per scan group
    b, d, l, g, dpg, _, valid_len = scan_cuda._validate(
        u, delta, A, B, C, D, delta_bias, None, 1, valid_len)
    mode = scan_cuda.compute_code(compute)
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((b, d, l), **f32)
    states = torch.empty((b, d, n_chunks(l), N_STATE), **f32)
    last = torch.empty((b, d, N_STATE), **f32)
    lib = cuda_build.load(FWD_SOURCE, _declare_fwd)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.medmamba_selective_scan_hillis_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), scan_cuda._ptr(D), scan_cuda._ptr(delta_bias),
            y.data_ptr(), states.data_ptr(), last.data_ptr(), b, g, dpg,
            N_STATE, l, valid_len, int(bool(delta_softplus)),
            scan_cuda._DTYPE_CODE[u.dtype], mode, stream)
    cuda_build.check_launch(lib, rc, "hillis selective-scan forward")
    HILLIS_LAUNCHES += 1
    return y, states, last


def selective_scan_hillis_bwd(u: torch.Tensor, delta: torch.Tensor,
                              A: torch.Tensor, B: torch.Tensor,
                              C: torch.Tensor, D: Optional[torch.Tensor],
                              delta_bias: Optional[torch.Tensor],
                              states: torch.Tensor, gy: torch.Tensor, *,
                              delta_softplus: bool = False,
                              valid_len: Optional[int] = None,
                              compute: str = "float32"):
    """Launch K4: the gradients of K3's y with respect to its inputs, in the
    compute mode of the forward (``compute``).

    Operands as for :func:`selective_scan_hillis_fwd`, plus the chunk-entry
    ``states`` it returned and gy (b, G*dpg, L) float32. Returns ``(du,
    ddelta, dA, dB, dC, dD, dbias)`` in the dtypes of their primals; dD and
    dbias are None where D and delta_bias are. At positions >= ``valid_len``
    gy counts as 0 and du and ddelta are 0, as the TPU kernel masks them.
    Every output is the same bits on every launch: no atomics.
    """
    global HILLIS_BWD_LAUNCHES
    # the operands of K1 with one u group per scan group
    b, d, l, g, dpg, _, valid_len = scan_cuda._validate(
        u, delta, A, B, C, D, delta_bias, None, 1, valid_len)
    mode = scan_cuda.compute_code(compute)
    device = u.device
    scan_cuda._check("states", states, device, (torch.float32,),
                     (b, d, n_chunks(l), N_STATE))
    scan_cuda._check("gy", gy, device, (torch.float32,), (b, d, l))

    du = torch.empty_like(u)
    ddelta = torch.empty_like(delta)
    f32 = dict(dtype=torch.float32, device=device)
    dA = torch.empty((d, N_STATE), **f32)
    dB = torch.empty((b, g, N_STATE, l), **f32)
    dC = torch.empty((b, g, N_STATE, l), **f32)
    dD = torch.empty((d,), **f32) if D is not None else None
    dbias = torch.empty((d,), **f32) if delta_bias is not None else None
    lib = cuda_build.load(BWD_SOURCE, _declare_bwd)
    # the 64-step tile-entry states the walk starts from, and its partial
    # sums, which its last kernel adds in a fixed order
    ws = torch.empty(
        (lib.medmamba_selective_scan_hillis_bwd_workspace(b, g, dpg, l),),
        **f32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.medmamba_selective_scan_hillis_bwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), scan_cuda._ptr(D), scan_cuda._ptr(delta_bias),
            states.data_ptr(), gy.data_ptr(), du.data_ptr(),
            ddelta.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scan_cuda._ptr(dD), scan_cuda._ptr(dbias), ws.data_ptr(), b, g,
            dpg, N_STATE, l, valid_len, int(bool(delta_softplus)),
            scan_cuda._DTYPE_CODE[u.dtype], mode, stream)
    cuda_build.check_launch(lib, rc, "hillis selective-scan backward")
    HILLIS_BWD_LAUNCHES += 1
    return du, ddelta, dA, dB.to(B.dtype), dC.to(C.dtype), dD, dbias
