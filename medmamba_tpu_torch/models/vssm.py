"""MedMamba VSSM in PyTorch (NHWC at the public interface).

Counterpart of ``medmamba_tpu/models/vssm.py``. Submodule and parameter names
follow the reference MedMamba state dict, so a reference ``model_state_dict``
loads with ``strict=True``:

* ``layers.{i}.blocks.{j}.self_attention`` is SS2D, with raw parameters
  ``x_proj_weight``, ``dt_projs_weight``, ``dt_projs_bias``, ``A_logs`` and
  ``Ds``;
* ``layers.{i}.blocks.{j}.conv33conv33conv11`` is the conv branch, an
  ``nn.Sequential`` of BN(0) conv3x3(1) BN(2) ReLU conv3x3(4) BN(5) ReLU
  conv1x1(7) ReLU.

Activations stay NHWC between blocks as in the JAX package; convolutions run
on NCHW views.

``dtype`` is the block dtype, as flax's ``dtype=``: parameters stay float32
and each layer casts its input and its parameters to the block dtype where it
uses them (no ``torch.autocast``, whose LayerNorm and matmul rules differ from
flax's). LayerNorm and BatchNorm statistics are float32 and the LayerNorm
output is cast back to the block dtype; the scan core is float32 and emits y
in the block dtype; ``out_norm`` runs in float32 and the logits are float32.

Training randomness comes from a ``torch.Generator`` that the caller passes
to ``forward``, never from the global generator.

Grad-CAM reads activations through taps (:meth:`VSSM.tap_site`), not forward
hooks: the convolutions run as ``F.conv2d`` on the modules' weights, so a
hook on a ``Conv2d`` would never fire. A tap is a callback in a module's
``taps`` dict; the dicts are empty unless a CAM is being computed, and add
no parameters or buffers.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from medmamba_tpu_torch.data.transforms import global_rand
from medmamba_tpu_torch.ops.cross_scan import cross_merge_fr, cross_scan_fwd
from medmamba_tpu_torch.ops.selective_scan import selective_scan
from medmamba_tpu_torch.parallel.mesh import (all_reduce_sum, copy_to_model,
                                              data_group, from_shards,
                                              model_shard, shard_group)
from medmamba_tpu_torch.utils import tracing

# ---------------------------------------------------------------------------
# Initializers (the distributions of medmamba_tpu/models/vssm.py:46-94), all
# drawn from an explicit generator
# ---------------------------------------------------------------------------


@torch.no_grad()
def trunc_normal(w: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """flax ``truncated_normal(stddev=std)``: a standard normal cut at +/-2,
    scaled so that the cut distribution has standard deviation ``std``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    w.erfinv_().mul_(math.sqrt(2) * std / 0.87962566103423978)


def trunc_normal_02(w: torch.Tensor, gen: torch.Generator) -> None:
    trunc_normal(w, 0.02, gen)


@torch.no_grad()
def kaiming_fan_out(w: torch.Tensor, gen: torch.Generator) -> None:
    """variance_scaling(2, "fan_out", "normal") of an OIHW conv weight."""
    fan_out = w.shape[0] * w[0, 0].numel()
    w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)


@torch.no_grad()
def uniform_sym(w: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    w.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def dt_bias_init(w: torch.Tensor, gen: torch.Generator, dt_min: float = 1e-3,
                 dt_max: float = 0.1, floor: float = 1e-4) -> None:
    """Inverse softplus of a log-uniform dt sample."""
    u = torch.rand(w.shape, generator=gen)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min)).clamp_min(floor)
    w.copy_(dt + torch.log(-torch.expm1(-dt)))


# ---------------------------------------------------------------------------
# Layers, with flax's dtype rules
# ---------------------------------------------------------------------------


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``layer`` in ``dtype``. With a weight partitioned over the model
    axis (``parallel/mesh.py: partition_params``) it is column-parallel:
    this rank's output features, gathered, then the replicated bias."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    shard = model_shard(layer.weight)
    if shard is None:
        return F.linear(x.to(dtype), layer.weight.to(dtype), bias)
    group = shard_group(shard)
    y = from_shards(F.linear(copy_to_model(x.to(dtype), group),
                             layer.weight.to(dtype)), group, -1)
    return y if bias is None else y + bias


def _whole(p: torch.Tensor) -> torch.Tensor:
    """A parameter whole: gathered over the model axis where it is
    partitioned (its adjoint keeps this rank's slice)."""
    shard = model_shard(p)
    if shard is None:
        return p
    return from_shards(p, shard_group(shard), shard[0])


def _bmm_float32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` with float32 products: bfloat16 operands keep
    their products in float32 (``out_dtype`` on the card, a float32 GEMM of
    the same values on the CPU, which has no such kernel)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _SharedWeightBmm(torch.autograd.Function):
    """``w @ x[i]`` for every matrix of a batch ``x``: one batched GEMM
    whose (m, k) weight has batch stride 0, so neither operand is copied.
    The weight's gradient sums the products ``g[i] @ x[i]^T``, each kept
    in float32 and rounded once, after the sum: exact up to the order of
    summation, as one GEMM over the whole batch is, and with as many
    thread blocks as the batch has matrices."""

    @staticmethod
    def forward(ctx, w, x):
        ctx.save_for_backward(w, x)
        return torch.bmm(w.expand(x.shape[0], -1, -1), x)

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        gw = gx = None
        if ctx.needs_input_grad[0]:
            gw = _bmm_float32(g, x.transpose(1, 2)).sum(0)
        if ctx.needs_input_grad[1]:
            gx = torch.bmm(w.t().expand(g.shape[0], -1, -1), g)
        return gw, gx


def _shared_bmm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (b, k, n) -> (b, m, n) without copying ``x``; a plain
    ``torch.bmm`` where no gradient is taken (``torch.export`` traces
    that)."""
    if torch.is_grad_enabled() and (w.requires_grad or x.requires_grad):
        return _SharedWeightBmm.apply(w, x)
    return torch.bmm(w.expand(x.shape[0], -1, -1), x)


def _pair_blocks(w: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """(4, p, q) per-direction matrices -> (2, 2p, 2q): each scan pair's
    two directions (0, 1 and 2, 3) as one block-diagonal matrix."""
    _, p, q = w.shape
    return (w.reshape(2, 2, p, 1, q) * eye.reshape(1, 2, 1, 2, 1)
            ).reshape(2, 2 * p, 2 * q)


def ss2d_projections(u: torch.Tensor, x_proj_weight: torch.Tensor,
                     dt_projs_weight: torch.Tensor, d_state: int):
    """SS2D's two low-rank projections, on the scan's own layout.

    ``u`` (b, 2D, L) is directions 0 and 1 (``cross_scan_fwd``), which
    directions 2 and 3 read in reverse; ``x_proj_weight`` (4, r + 2n, D)
    and ``dt_projs_weight`` (4, D, r) are in ``u``'s dtype. Returns, for
    pair 0 (directions 0, 1) and pair 1 (2, 3), ``(delta, B, C)``: delta
    (b, 2D, L) and B, C (b, 2, n, L), contiguous, as ``selective_scan``
    reads them.

    Each GEMM runs on ``u``'s layout, L contiguous, one matrix a batch row
    (``_shared_bmm``): x_dbl (b, 4 c8, L) = W @ u, its rows pair by pair
    the two directions' dt rows, then B rows, then C rows, with W (4 c8, 2D)
    block-diagonal over each pair's directions; then delta = W_dt @ dt
    rows, pair by pair. The dt rank r is zero-padded to r8, the next
    multiple of 8 (x_proj_weight's dt rows and dt_projs_weight's last
    axis), so every operand's leading dimension is a multiple of 8
    elements; the padded rows of x_dbl meet zero columns of W_dt, so the
    result is unchanged and no gradient reaches a padded slot. Only B and C
    are copied, to their contiguous layout.
    """
    b, _, l = u.shape
    n = d_state
    r = dt_projs_weight.shape[-1]
    r8 = -(-r // 8) * 8
    eye = torch.eye(2, dtype=u.dtype, device=u.device)
    w_dt, w_b, w_c = x_proj_weight.split([r, n, n], dim=1)
    if r8 != r:
        tracing.count("ss2d.proj_padded")
        w_dt = F.pad(w_dt, (0, 0, 0, r8 - r))
        dt_projs_weight = F.pad(dt_projs_weight, (0, r8 - r))
    w_x = torch.cat([_pair_blocks(w, eye) for w in (w_dt, w_b, w_c)], 1)
    x_dbl = _shared_bmm(w_x.reshape(-1, u.shape[1]), u)
    w_dt = _pair_blocks(dt_projs_weight, eye).unbind(0)   # 2 x (2D, 2 r8)
    parts = x_dbl.split([2 * r8, 2 * n, 2 * n] * 2, dim=1)
    return [(_shared_bmm(w, dts), bs.reshape(b, 2, n, l).contiguous(),
             cs.reshape(b, 2, n, l).contiguous())
            for w, (dts, bs, cs) in zip(w_dt, (parts[:3], parts[3:]))]


def _conv(layer: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    layer.padding, layer.dilation, layer.groups)


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """Statistics and affine in float32, the result in ``dtype``."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(dtype)


# The conv branch's JAX module names (medmamba_tpu/models/vssm.py:506-513) by
# index in ``conv33conv33conv11``; the ReLUs there are functions, not modules
JAX_CONV_NAMES = {"conv_bn0": 0, "conv3x3_0": 1, "conv_bn1": 2,
                  "conv3x3_1": 4, "conv_bn2": 5, "conv1x1": 7}
CONV_BRANCH = "conv33conv33conv11"


def _tap(taps: dict, point: str, x: torch.Tensor,
         nchw: bool = False) -> torch.Tensor:
    """``x`` through the callback at ``point``, if there is one. An NCHW
    activation is shown to the callback as NHWC, the JAX model's layout."""
    fn = taps.get(point)
    if fn is None:
        return x
    if nchw:
        return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return fn(x)


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity in eval mode or at rate 0.

    The keep mask is drawn by :meth:`sample` from the caller's generator
    and passed to ``forward``, so a recomputation under activation
    checkpointing applies the same mask."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def sample(self, batch: int, generator: Optional[torch.Generator],
               device, rows: Optional[Tuple[int, int]] = None
               ) -> Optional[torch.Tensor]:
        """The per-sample keep mask (bool, (batch,)) of one training
        forward, or None where the layer is the identity; ``rows`` =
        (start, total) draws it for a global batch of ``total`` rows and
        keeps this batch's (``data/transforms.py: global_rand``)."""
        if not self.training or self.rate == 0.0:
            return None
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator")
        return (global_rand(generator, batch, rows) < 1.0 - self.rate
                ).to(device)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is None:
            return x
        mask = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over axis 1 (NCHW) with an optional per-sample validity mask.

    Eval mode normalises with the running statistics. Train mode uses the
    batch statistics of the rows whose mask is true (padded rows of a final
    partial batch do not bias them) and updates the running statistics as
    ``flax.linen.BatchNorm(momentum=0.9)`` does: the running variance is the
    biased batch variance. Parameter and buffer names are ``nn.BatchNorm2d``'s.

    Statistics are float32 whatever the input dtype; the normalisation runs
    in the input's dtype, as the JAX ``MaskedBatchNorm`` does. With
    ``update_stats`` false (a recomputation under activation
    checkpointing) the running statistics are left as they are.

    In training under an active mesh whose data axis has more than one rank
    (``parallel/mesh.py``), the masked sums (the count, Σx·w, Σx²·w, one
    vector) are summed over the data axis first, so the batch statistics,
    their gradients and the running statistics are the global batch's, as
    GSPMD makes them for the JAX module on a mesh.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.update_stats = True

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            red = [0] + list(range(2, x.ndim))
            group = data_group()
            if group is not None and dist.get_world_size(group) > 1:
                mean, var = self._global_stats(xf, mask, red, group)
            elif mask is None:
                mean = xf.mean(red)
                var = (xf * xf).mean(red) - mean * mean
            else:
                w = mask.float().reshape((x.shape[0],) + (1,) * (x.ndim - 1))
                per_sample = float(math.prod(x.shape[2:]))
                cnt = torch.clamp_min(w.sum() * per_sample, 1.0)
                mean = (xf * w).sum(red) / cnt
                var = (xf * xf * w).sum(red) / cnt - mean * mean
            var = var.clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean)
                    self.running_var.mul_(m).add_((1 - m) * var)
                    self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        dt = x.dtype
        return (x - mean.to(dt).reshape(shape)) * inv.to(dt).reshape(shape) \
            + self.bias.to(dt).reshape(shape)


    @staticmethod
    def _global_stats(xf: torch.Tensor, mask: Optional[torch.Tensor], red,
                      group) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and biased variance of the valid rows of every rank's
        batch: the rank's masked sums, packed into one vector, summed over
        ``group`` by one differentiable all-reduce."""
        w = (torch.ones(xf.shape[0], device=xf.device) if mask is None
             else mask.float())
        per_sample = float(math.prod(xf.shape[2:]))
        wb = w.reshape((xf.shape[0],) + (1,) * (xf.ndim - 1))
        sums = all_reduce_sum(torch.cat([
            (w.sum() * per_sample).reshape(1), (xf * wb).sum(red),
            (xf * xf * wb).sum(red)]), group)
        c = xf.shape[1]
        cnt = torch.clamp_min(sums[0], 1.0)
        mean = sums[1:1 + c] / cnt
        return mean, sums[1 + c:] / cnt - mean * mean


@contextlib.contextmanager
def _frozen_batch_stats(module: nn.Module):
    """Leave the running statistics of ``module``'s BatchNorms alone while
    the block is recomputed for its backward."""
    bns = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class PatchEmbed2D(nn.Module):
    """4x4 non-overlapping conv patchify + optional LayerNorm."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 patch_norm: bool = True, dtype=torch.float32, *,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        kaiming_fan_out(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C_in)
        x = _conv(self.proj, x.permute(0, 3, 1, 2), self.dtype)
        x = x.permute(0, 2, 3, 1)
        if self.norm is not None:
            x = _layer_norm(self.norm, x, self.dtype)
        return x


class PatchMerging2D(nn.Module):
    """2x downsample: 2x2 gather -> LN(4C) -> Linear(2C, no bias).

    Gather order (even/even, odd/even, even/odd, odd/odd); an odd size is
    cropped to its even part."""

    def __init__(self, dim: int, dtype=torch.float32, *,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        trunc_normal_02(self.reduction.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        hh, ww = x.shape[1] // 2, x.shape[2] // 2
        x = torch.cat([x[:, 0::2, 0::2][:, :hh, :ww],
                       x[:, 1::2, 0::2][:, :hh, :ww],
                       x[:, 0::2, 1::2][:, :hh, :ww],
                       x[:, 1::2, 1::2][:, :hh, :ww]], dim=-1)
        return _linear(self.reduction,
                       _layer_norm(self.norm, x, self.dtype), self.dtype)


class SS2D(nn.Module):
    """2D selective scan module.

    in_proj -> (x, z) -> depthwise 3x3 conv + SiLU -> CrossScan -> per-direction
    dt/B/C projections -> selective scan -> CrossMerge -> LayerNorm -> gate
    with silu(z) -> out_proj. Directions 2/3 are reversals of 0/1, so the scan
    runs twice on the same (B, 2, D, L) tensor: forward, then in reverse.

    ``scan_impl``: "auto" (the CUDA kernels on a CUDA tensor, the plain
    version on a CPU tensor) or "ref" (the plain version on any device). On
    a CUDA tensor ``MEDMAMBA_SCAN_KERNEL`` picks the kernels at each call, as
    in the JAX package: ``ssd`` (default, K1/K2) or ``hillis`` (K3/K4).
    ``scan_tau`` is accepted for the JAX package's signature and does nothing:
    every scan here is exact.

    Partitioned over a mesh's model axis (``parallel/mesh.py``), SS2D
    gathers its ``x_proj_weight``, ``dt_projs_weight``, ``A_logs`` and
    ``Ds`` shards before use (a few KB to a few hundred KB each), its
    projections are column-parallel (``_linear``), and the scan takes its
    parallelism from the batch: each model rank scans its rows
    (``ops.selective_scan``), as in the JAX package.
    """

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3,
                 expand: int = 2, dt_rank: Optional[int] = None,
                 dropout: float = 0.0, conv_bias: bool = True,
                 bias: bool = False, scan_impl: str = "auto", scan_tau=None,
                 dtype=torch.float32, *, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.d_state = d_state
        self.d_inner = d_inner = expand * d_model
        self.dt_rank = dt_rank = dt_rank or math.ceil(d_model / 16)
        self.scan_impl = scan_impl
        k, n = 4, d_state
        gen = generator

        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=bias)
        trunc_normal_02(self.in_proj.weight, gen)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv,
                                padding=(d_conv - 1) // 2, groups=d_inner,
                                bias=conv_bias)
        kaiming_fan_out(self.conv2d.weight, gen)
        self.x_proj_weight = nn.Parameter(torch.empty(k, dt_rank + 2 * n,
                                                      d_inner))
        uniform_sym(self.x_proj_weight, d_inner ** -0.5, gen)
        self.dt_projs_weight = nn.Parameter(torch.empty(k, d_inner, dt_rank))
        uniform_sym(self.dt_projs_weight, dt_rank ** -0.5, gen)
        self.dt_projs_bias = nn.Parameter(torch.empty(k, d_inner))
        dt_bias_init(self.dt_projs_bias, gen)
        self.A_logs = nn.Parameter(
            torch.log(torch.arange(1, n + 1, dtype=torch.float32))
            .repeat(k * d_inner, 1))
        self.Ds = nn.Parameter(torch.ones(k * d_inner))
        self.out_norm = nn.LayerNorm(d_inner, eps=1e-5)
        self.out_proj = nn.Linear(d_inner, d_model, bias=bias)
        trunc_normal_02(self.out_proj.weight, gen)
        if bias:
            nn.init.zeros_(self.in_proj.bias)
            nn.init.zeros_(self.out_proj.bias)
        if conv_bias:
            nn.init.zeros_(self.conv2d.bias)
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, d_model)
        b, h, w, _ = x.shape
        l = h * w
        d_inner, n = self.d_inner, self.d_state
        dt_ = self.dtype

        x, z = _linear(self.in_proj, x, dt_).chunk(2, dim=-1)
        x = F.silu(_conv(self.conv2d, x.permute(0, 3, 1, 2), dt_))
        u = cross_scan_fwd(x.permute(0, 2, 3, 1)).reshape(b, 2 * d_inner, l)

        # weights are laid out [pair j][direction k]: pair 0 (directions 0, 1)
        # scans forward, pair 1 (directions 2, 3) the same data in reverse
        proj = ss2d_projections(u, _whole(self.x_proj_weight).to(dt_),
                                _whole(self.dt_projs_weight).to(dt_), n)
        As = -torch.exp(_whole(self.A_logs).float()).reshape(4, d_inner, n)
        Ds = _whole(self.Ds).float().reshape(4, d_inner)
        bias = self.dt_projs_bias.float()

        def scan_pair(j: int, rev: bool) -> torch.Tensor:
            ks = slice(2 * j, 2 * j + 2)
            delta, bs, cs = proj[j]
            y = selective_scan(
                u, delta, As[ks].reshape(2 * d_inner, n), bs, cs,
                Ds[ks].reshape(-1), delta_bias=bias[ks].reshape(-1),
                delta_softplus=True, impl=self.scan_impl,
                reverse_dirs=(rev, rev), out_dtype=dt_)
            # the block dtype before the merge, as the JAX model casts
            # (its vssm.py:442): the hillis scan returns float32 y
            return y.to(dt_).reshape(b, 2, d_inner, l)

        y = cross_merge_fr(scan_pair(0, False), scan_pair(1, True), h, w)
        # out_norm in float32 whatever the block dtype (the JAX model's
        # vssm.py:447-454)
        y = _layer_norm(self.out_norm,
                        y.transpose(1, 2).reshape(b, h, w, d_inner),
                        torch.float32)
        out = _linear(self.out_proj, y.to(dt_) * F.silu(z), dt_)
        return self.dropout(out) if self.dropout is not None else out


class SSConvSSM(nn.Module):
    """The SS-Conv-SSM hybrid block.

    Channel-split halves: right half -> LN -> SS2D -> DropPath; left half ->
    BN-Conv3x3-BN-ReLU-Conv3x3-BN-ReLU-Conv1x1-ReLU; concat +
    channel_shuffle(2) (an interleave of the halves) -> residual add.
    """

    def __init__(self, hidden_dim: int, drop_path: float = 0.0,
                 attn_drop_rate: float = 0.0, d_state: int = 16,
                 scan_impl: str = "auto", dtype=torch.float32, *,
                 generator: torch.Generator):
        super().__init__()
        half = hidden_dim // 2
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(half, eps=1e-5)
        self.self_attention = SS2D(half, d_state=d_state,
                                   dropout=attn_drop_rate,
                                   scan_impl=scan_impl, dtype=dtype,
                                   generator=generator)
        self.drop_path = DropPath(drop_path)
        convs = [nn.Conv2d(half, half, 3, padding=1),
                 nn.Conv2d(half, half, 3, padding=1),
                 nn.Conv2d(half, half, 1)]
        for c in convs:
            kaiming_fan_out(c.weight, generator)
            nn.init.zeros_(c.bias)
        self.conv33conv33conv11 = nn.Sequential(
            MaskedBatchNorm(half), convs[0], MaskedBatchNorm(half), nn.ReLU(),
            convs[1], MaskedBatchNorm(half), nn.ReLU(), convs[2], nn.ReLU())
        # Grad-CAM taps: "" (the block's output), "ln_1", "self_attention",
        # "conv33conv33conv11.<index>" (that layer's output, NHWC)
        self.taps = {}

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: rows that count in the BatchNorm statistics; ``keep``:
        the DropPath keep mask (``self.drop_path.sample``), None for none."""
        taps = self.taps
        left, right = x.chunk(2, dim=-1)
        r = _layer_norm(self.ln_1, right, self.dtype)
        if taps:
            r = _tap(taps, "ln_1", r)
        r = self.self_attention(r)
        if taps:
            r = _tap(taps, "self_attention", r)
        r = self.drop_path(r, keep)
        c = left.permute(0, 3, 1, 2)
        for k, layer in enumerate(self.conv33conv33conv11):
            if isinstance(layer, MaskedBatchNorm):
                c = layer(c, mask)
            elif isinstance(layer, nn.Conv2d):
                c = _conv(layer, c, self.dtype)
            else:
                c = layer(c)
            if taps:
                c = _tap(taps, f"{CONV_BRANCH}.{k}", c, nchw=True)
        c = c.permute(0, 2, 3, 1)
        # concat + channel_shuffle(groups=2) == out[..., 2j] = c[..., j],
        # out[..., 2j + 1] = r[..., j]
        out = torch.stack([c, r], dim=-1).reshape(x.shape) + x
        return _tap(taps, "", out) if taps else out


class VSSLayer(nn.Module):
    """One stage: depth x SSConvSSM (+ optional PatchMerging2D)."""

    def __init__(self, dim: int, depth: int, d_state: int = 16,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = (),
                 downsample: bool = False, scan_impl: str = "auto",
                 use_checkpoint: bool = False, dtype=torch.float32, *,
                 generator: torch.Generator):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.blocks = nn.ModuleList(
            SSConvSSM(dim, drop_path=drop_path[i] if i < len(drop_path)
                      else 0.0, attn_drop_rate=attn_drop, d_state=d_state,
                      scan_impl=scan_impl, dtype=dtype, generator=generator)
            for i in range(depth))
        self.downsample = (PatchMerging2D(dim, dtype, generator=generator)
                           if downsample else None)
        self.taps = {}        # Grad-CAM tap "": the stage's output

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        for blk in self.blocks:
            keep = blk.drop_path.sample(x.shape[0], generator, x.device,
                                        rows)
            if self.use_checkpoint and torch.is_grad_enabled():
                # activations rematerialised in the backward, as nn.remat
                # does in the JAX model; the recomputation reuses the keep
                # mask and leaves the BatchNorm running statistics alone
                x = checkpoint(blk, x, mask, keep, use_reentrant=False,
                               context_fn=lambda blk=blk: (
                                   contextlib.nullcontext(),
                                   _frozen_batch_stats(blk)))
            else:
                x = blk(x, mask, keep)
        if self.downsample is not None:
            x = self.downsample(x)
        return _tap(self.taps, "", x) if self.taps else x


class VSSM(nn.Module):
    """MedMamba top model. Input NHWC (B, H, W, 3); output float32 logits
    (B, num_classes). Parameters are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when none is given) on the CPU; move the
    model with ``.to(device)``. ``scan_tau`` is accepted for the JAX
    package's signature and does nothing (see ``SS2D``). ``dtype`` is the
    block dtype (float32 or bfloat16); ``use_checkpoint`` recomputes each
    block's activations in the backward. Its layers go through the model
    axis's seams (``_linear``, ``SS2D``), so it can be partitioned
    (``parallel/mesh.py: partition_params``)."""

    TENSOR_PARALLEL = True

    def __init__(self, patch_size: int = 4, num_classes: int = 1000,
                 depths: Sequence[int] = (2, 2, 4, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 d_state: Optional[int] = 16, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 patch_norm: bool = True, scan_impl: str = "auto",
                 scan_tau=None, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, use_checkpoint: bool = False):
        super().__init__()
        self.dtype = dtype
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        num_layers = len(depths)
        d_state = math.ceil(dims[0] / 6) if d_state is None else d_state
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed2D(patch_size, dims[0], patch_norm,
                                        dtype, generator=gen)
        self.pos_drop = nn.Dropout(drop_rate) if drop_rate > 0.0 else None
        total = sum(depths)
        dpr = [0.0] if total == 1 else \
            [drop_path_rate * i / (total - 1) for i in range(total)]
        self.layers = nn.ModuleList(
            VSSLayer(dims[i], depths[i], d_state=d_state,
                     attn_drop=attn_drop_rate,
                     drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                     downsample=i < num_layers - 1, scan_impl=scan_impl,
                     use_checkpoint=use_checkpoint, dtype=dtype,
                     generator=gen)
            for i in range(num_layers))
        self.head = nn.Linear(dims[-1], num_classes)
        trunc_normal_02(self.head.weight, gen)
        nn.init.zeros_(self.head.bias)

    def forward_backbone(self, x: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         rows: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
        """Feature extractor: the final NHWC feature map, in the block
        dtype. ``mask`` marks the rows that count in the BatchNorm
        statistics; ``generator`` feeds DropPath in training, its draws
        made for the global batch that ``rows`` = (start, total) names
        (``DropPath.sample``)."""
        x = self.patch_embed(x.to(self.dtype))
        if self.pos_drop is not None:
            x = self.pos_drop(x)
        for layer in self.layers:
            x = layer(x, mask, generator, rows)
        return x

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x = self.forward_backbone(x, mask, generator, rows)
        return _linear(self.head, x.mean(dim=(1, 2)), self.dtype).float()

    def tap_site(self, path: Union[str, Sequence[str]]
                 ) -> Tuple[nn.Module, str]:
        """(module, tap point) of an activation named by its JAX module path
        (``layers_i``, ``layers_i.blocks_j``, ``layers_i.blocks_j.<name>``
        with <name> one of ``ln_1``, ``self_attention``, ``conv_bn0``,
        ``conv3x3_0``, ``conv_bn1``, ``conv3x3_1``, ``conv_bn2``,
        ``conv1x1``; a string or a sequence of segments) or by the port's
        module names (``layers.i``, ``layers.i.blocks.j``,
        ``layers.i.blocks.j.conv33conv33conv11.k`` ...). As in the JAX
        model, a convolution's or BatchNorm's activation is taken before
        the ReLU that follows it. Raises ValueError naming an unknown
        path."""
        name = path if isinstance(path, str) else ".".join(path)
        m = re.fullmatch(r"layers[._](\d+)(?:\.blocks[._](\d+)(?:\.(.+))?)?",
                         name)
        if m and int(m.group(1)) < len(self.layers):
            layer = self.layers[int(m.group(1))]
            if m.group(2) is None:
                return layer, ""
            if int(m.group(2)) < len(layer.blocks):
                block = layer.blocks[int(m.group(2))]
                rest = m.group(3)
                if rest is None:
                    return block, ""
                if rest in ("ln_1", "self_attention"):
                    return block, rest
                if rest in JAX_CONV_NAMES:
                    return block, f"{CONV_BRANCH}.{JAX_CONV_NAMES[rest]}"
                k = re.fullmatch(rf"{CONV_BRANCH}\.(\d+)", rest)
                if k and int(k.group(1)) < len(block.conv33conv33conv11):
                    return block, rest
        raise ValueError(f"target path {name!r} not found in model")
