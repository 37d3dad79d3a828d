"""Flip + rotation augmentation: the kernel K5 on Hopper and its plain version.

Counterpart of ``medmamba_tpu/ops/rotate_pallas.py``. Per image, a
horizontal flip, then a nearest-neighbour rotation about the centre with zero
fill: exactly ``medmamba_tpu/data/transforms.py:_rotate_nearest`` after the
flip (the TPU kernel's two-pass approximation is not carried over; see
``csrc/rotate_flip.cu``). ``rotate_flip`` is the entry point: on a CUDA
tensor it launches K5, on a CPU tensor it runs ``rotate_flip_ref``.

``LAUNCHES`` counts K5 launches made through :func:`rotate_flip_cuda`.
"""
from __future__ import annotations

import ctypes

import torch

from medmamba_tpu_torch.ops import cuda_build

SOURCE = "rotate_flip.cu"

LAUNCHES = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_rotate_flip
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def rotate_flip_ref(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                    flip: torch.Tensor) -> torch.Tensor:
    """Plain version of K5. x (B, H, W, C) float32 NHWC; sin, cos (B,)
    float32 of each image's angle; flip (B,) bool. Source coordinates are
    rounded half to even, each product and sum rounded on its own."""
    b, h, w, _ = x.shape
    dev = x.device
    yy = (torch.arange(h, dtype=torch.float32, device=dev)
          - (h - 1) / 2.0)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev)
          - (w - 1) / 2.0)[None, None, :]
    s = sin.float()[:, None, None]
    c = cos.float()[:, None, None]
    yi = torch.round(c * yy + s * xx + (h - 1) / 2.0).long()
    xi = torch.round(-s * yy + c * xx + (w - 1) / 2.0).long()
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    yi = yi.clamp(0, h - 1)
    xi = xi.clamp(0, w - 1)
    xi = torch.where(flip.to(dev)[:, None, None], w - 1 - xi, xi)
    out = x[torch.arange(b, device=dev)[:, None, None], yi, xi]
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def rotate_flip_cuda(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                     flip: torch.Tensor) -> torch.Tensor:
    """Launch K5; the arguments of :func:`rotate_flip_ref`, on the card.
    Raises on anything the kernel does not take."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA rotation needs CUDA tensors, got x on "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 NHWC batch, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, h, w, ch = x.shape
    for name, v in (("sin", sin), ("cos", cos)):
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != (b,)):
            raise ValueError(f"{name} must be float32 ({b},) on {x.device}")
    if flip.device != x.device or tuple(flip.shape) != (b,):
        raise ValueError(f"flip must be ({b},) on {x.device}")
    sin, cos = sin.contiguous(), cos.contiguous()
    flip_i = flip.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.medmamba_rotate_flip(
            x.data_ptr(), sin.data_ptr(), cos.data_ptr(), flip_i.data_ptr(),
            out.data_ptr(), b, h, w, ch, stream)
    cuda_build.check_launch(lib, rc, "rotate/flip")
    LAUNCHES += 1
    return out


def rotate_flip(x: torch.Tensor, angles: torch.Tensor,
                flip: torch.Tensor) -> torch.Tensor:
    """Flip the flagged images horizontally, then rotate each by its angle
    (radians) about its centre. sin and cos are computed once here, so the
    kernel and the plain version see the same values. K5 on a CUDA tensor,
    the plain version on a CPU tensor."""
    angles = angles.float()
    sin, cos = torch.sin(angles), torch.cos(angles)
    if x.is_cuda:
        return rotate_flip_cuda(x, sin, cos, flip)
    return rotate_flip_ref(x, sin, cos, flip)
