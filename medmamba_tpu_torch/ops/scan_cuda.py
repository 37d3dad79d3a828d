"""The selective-scan kernels K1 (forward) and K2 (backward) on Hopper.

Counterparts of ``medmamba_tpu/ops/pallas_scan.py``'s ``_fwd_kernel_ssd`` and
``_bwd_kernel_ssd``. The kernels are ``csrc/selective_scan_fwd.cu`` and
``csrc/selective_scan_bwd.cu``, built and loaded by ``ops/cuda_build.py`` on
first launch.

``LAUNCHES`` counts K1 launches made through :func:`selective_scan_fwd` and
``BWD_LAUNCHES`` K2 launches made through :func:`selective_scan_bwd`. K2 is
a pair of kernels, the scan's adjoint and the fixed-order sum of its
partials, launched together by one call: the pair counts as one launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from medmamba_tpu_torch.ops import cuda_build

FWD_SOURCE = "selective_scan_fwd.cu"
BWD_SOURCE = "selective_scan_bwd.cu"
N_STATE = 16
TILE = 64          # K1's tile: the states hold one entry per tile
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
BWD_LAUNCHES = 0


def _declare_fwd(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.medmamba_selective_scan_bwd_workspace
    ws.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    ws.restype = None


def _check(name: str, x: torch.Tensor, device, dtypes, shape) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {x.dtype}, expected one of {dtypes}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _validate(u, delta, A, B, C, D, delta_bias, reverse_dirs, u_tile,
              valid_len):
    """Check the operands of either kernel; returns (b, d, l, g, dpg,
    rev_mask, valid_len)."""
    if u.device.type != "cuda":
        raise ValueError(f"the CUDA selective scan needs CUDA tensors, "
                         f"got u on {u.device}")
    device = u.device
    b, d, l = delta.shape
    g = B.shape[1]
    if g < 1 or d % g or g % u_tile:
        raise ValueError(f"{d} channels, {g} groups and u_tile {u_tile} "
                         "do not divide")
    dpg = d // g
    in_t = (u.dtype,) if u.dtype in _DTYPE_CODE else tuple(_DTYPE_CODE)
    _check("u", u, device, in_t, (b, g // u_tile * dpg, l))
    _check("delta", delta, device, in_t, (b, d, l))
    _check("B", B, device, in_t, (b, g, N_STATE, l))
    _check("C", C, device, in_t, (b, g, N_STATE, l))
    _check("A", A, device, (torch.float32,), (d, N_STATE))
    for name, x in (("D", D), ("delta_bias", delta_bias)):
        if x is not None:
            _check(name, x, device, (torch.float32,), (d,))
    rev_mask = 0
    if reverse_dirs is not None:
        if len(reverse_dirs) != g:
            raise ValueError(f"{len(reverse_dirs)} reverse flags for {g} groups")
        rev_mask = sum(1 << k for k, f in enumerate(reverse_dirs) if f)
    if valid_len is None:
        valid_len = l
    elif not 0 <= valid_len <= l:
        raise ValueError(f"valid_len {valid_len} outside [0, {l}]")
    return b, d, l, g, dpg, rev_mask, valid_len


def selective_scan_fwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None, *,
                       delta_softplus: bool = False,
                       reverse_dirs: Optional[Sequence[bool]] = None,
                       u_tile: int = 1, out_dtype=None,
                       valid_len: Optional[int] = None,
                       return_last_state: bool = False,
                       return_states: bool = False):
    """Launch K1 on CUDA tensors; the layouts of ``ops.selective_scan``.

    u (b, G/u_tile * dpg, L) and delta (b, G*dpg, L), B and C (b, G, 16, L),
    all float32 or all bfloat16; A (G*dpg, 16), D and delta_bias (G*dpg,)
    float32. Returns ``(y, last, states)``: y (b, G*dpg, L) in ``out_dtype``
    (float32 by default); with ``return_last_state`` the float32 state
    (b, G*dpg, 16) after each channel's last scanned step, else None; with
    ``return_states`` the float32 state at the entry of every 64-step tile,
    (b, G*dpg, n_tiles, 16) in processing order (K2's input), else None.

    Raises on anything the kernel does not take, and when a gradient is
    required: y carries no autograd history, so differentiable calls go
    through ``ops.selective_scan``, whose backward is K2.
    """
    global LAUNCHES
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (u, delta, A, B, C, D, delta_bias)):
        raise RuntimeError("selective_scan_fwd has no backward of its own; "
                           "call medmamba_tpu_torch.ops.selective_scan")
    b, d, l, g, dpg, rev_mask, valid_len = _validate(
        u, delta, A, B, C, D, delta_bias, reverse_dirs, u_tile, valid_len)
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype {out_dtype} is not float32 or bfloat16")

    device = u.device
    y = torch.empty((b, d, l), dtype=out_dtype, device=device)
    last = (torch.empty((b, d, N_STATE), dtype=torch.float32, device=device)
            if return_last_state else None)
    states = (torch.empty((b, d, -(-l // TILE), N_STATE), dtype=torch.float32,
                          device=device) if return_states else None)
    lib = cuda_build.load(FWD_SOURCE, _declare_fwd)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.medmamba_selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), _ptr(D), _ptr(delta_bias), y.data_ptr(),
            _ptr(last), _ptr(states), b, g, g // u_tile, dpg, N_STATE, l,
            valid_len, int(bool(delta_softplus)), rev_mask,
            _DTYPE_CODE[u.dtype], _DTYPE_CODE[out_dtype], stream)
    cuda_build.check_launch(lib, rc, "selective-scan forward")
    LAUNCHES += 1
    return y, last, states


def selective_scan_bwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor],
                       delta_bias: Optional[torch.Tensor],
                       states: torch.Tensor, gy: torch.Tensor, *,
                       delta_softplus: bool = False,
                       reverse_dirs: Optional[Sequence[bool]] = None,
                       u_tile: int = 1,
                       valid_len: Optional[int] = None):
    """Launch K2: the gradients of K1's y with respect to its inputs.

    Operands as for :func:`selective_scan_fwd`, plus the tile-entry
    ``states`` it returned and gy (b, G*dpg, L), float32 or bfloat16.
    Returns ``(du, ddelta, dA, dB, dC, dD, dbias)`` in the dtypes of their
    primals (du and ddelta in u's, dB and dC in B's, the rest float32); dD
    and dbias are None where D and delta_bias are. With ``u_tile > 1`` the
    tiled groups' du are summed onto the shared u, as the JAX package's
    ``_vjp_bwd`` does.
    """
    global BWD_LAUNCHES
    b, d, l, g, dpg, rev_mask, valid_len = _validate(
        u, delta, A, B, C, D, delta_bias, reverse_dirs, u_tile, valid_len)
    device = u.device
    _check("states", states, device, (torch.float32,),
           (b, d, -(-l // TILE), N_STATE))
    _check("gy", gy, device, tuple(_DTYPE_CODE), (b, d, l))

    du = torch.empty((b, d, l), dtype=u.dtype, device=device)
    ddelta = torch.empty_like(delta)
    f32 = dict(dtype=torch.float32, device=device)
    dA = torch.empty((d, N_STATE), **f32)
    dB = torch.empty((b, g, N_STATE, l), **f32)
    dC = torch.empty((b, g, N_STATE, l), **f32)
    dD = torch.empty((d,), **f32) if D is not None else None
    dbias = torch.empty((d,), **f32) if delta_bias is not None else None
    lib = cuda_build.load(BWD_SOURCE, _declare_bwd)
    # the kernel's partial sums, which its second kernel adds in a fixed
    # order: dB/dC per channel block, dA, dD and dbias per batch row
    sizes = (ctypes.c_longlong * 4)()
    lib.medmamba_selective_scan_bwd_workspace(b, g, dpg, l, sizes)
    ws = [torch.empty((n,), **f32) for n in sizes]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.medmamba_selective_scan_bwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), _ptr(D), _ptr(delta_bias), states.data_ptr(),
            gy.data_ptr(), du.data_ptr(), ddelta.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), _ptr(dD), _ptr(dbias),
            *(w.data_ptr() for w in ws), b, g, g // u_tile, dpg, N_STATE, l,
            valid_len, int(bool(delta_softplus)), rev_mask,
            _DTYPE_CODE[u.dtype], _DTYPE_CODE[gy.dtype], stream)
    cuda_build.check_launch(lib, rc, "selective-scan backward")
    BWD_LAUNCHES += 1
    if u_tile > 1:
        # the shared u fed every tiled group: sum their cotangents
        du = du.reshape(b, u_tile, d // u_tile, l).sum(1, dtype=torch.float32)
        du = du.to(u.dtype)
    return du, ddelta, dA, dB.to(B.dtype), dC.to(C.dtype), dD, dbias
