"""The plain reference of the benchmark: MedMamba's VSSM in float32 PyTorch.

Written from the published model (arXiv:2403.03849; the upstream
``MedMamba.py``: SS2D, SS_Conv_SSM, PatchMerging2D, VSSM) and nothing of
the program under test: it imports no kernel, no module of the port and no
JAX. Parameters live in a flat dict keyed by the upstream state-dict names,
which the program under test also uses, so the benchmark hands the same
weights to both sides.

* :func:`make_weights` draws every parameter from a seed on the given
  device, in one uniform draw cut into leaves (see its docstring).
* :func:`forward` is the model on a uint8 NHWC batch, in train mode (batch
  statistics, the augmentation and DropPath drawn from a generator) or in
  eval mode (running statistics).
* :func:`scan` is the selective scan as a sequential loop over the
  sequence, float32.
* :func:`adamw_step` is AdamW (decoupled decay, bias-corrected moments).

``quant`` is the control's hook (:data:`FP8`): its call rounds a tensor
wherever the program under test computes in its block dtype (each
operand and result of a product or convolution, each normalisation's and
activation's result, the scan's output, the residual stream), and its
``output`` the gradient that reaches each product's result; None leaves
everything float32.
Matrix products and convolutions run without TF32 unless the caller turns
it on.

The draws follow the training recipe's order: per step the flips, then the
angles (one uniform each per row), then one uniform per row for each block
whose DropPath rate is above 0, block by block.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-5
BN_EPS = 1e-5
MAX_ROTATE_DEG = 10.0
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4
BRANCH = "conv33conv33conv11"
SCAN_ROWS = 16           # batch rows a scan holds at a time


def _block_dims(cfg: dict) -> List[Tuple[int, int, int]]:
    """(stage, block, dim) of every SS-Conv-SSM block."""
    return [(i, j, dim) for i, (depth, dim) in
            enumerate(zip(cfg["depths"], cfg["dims"])) for j in range(depth)]


def ss2d_sizes(dim: int, d_state: int) -> Tuple[int, int, int]:
    """(d_model, d_inner, dt_rank) of the SS2D of a block of width ``dim``:
    it runs on half the channels, expanded twice."""
    half = dim // 2
    return half, 2 * half, math.ceil(half / 16)


def drop_path_rates(cfg: dict) -> List[float]:
    """Per block, the stochastic-depth rate: linear from 0 to the
    configuration's rate over all blocks."""
    total = sum(cfg["depths"])
    rate = cfg["drop_path_rate"]
    return [0.0] if total == 1 else [rate * i / (total - 1)
                                     for i in range(total)]


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every parameter as (name, shape, kind, scale). Kinds: ``uniform``
    (U(-scale, scale)), ``const`` (filled with scale), ``dt_bias`` (the
    inverse softplus of a log-uniform time step), ``a_log``
    (log 1..d_state on every channel)."""
    n = cfg["d_state"]
    p, d0 = cfg["patch_size"], cfg["dims"][0]
    out = []

    def trunc02(name, shape):          # a Linear's weight: std 0.02
        out.append((name, shape, "uniform", 0.02 * math.sqrt(3)))

    def conv(name, shape):             # fan-out normal's std, as a uniform
        fan_out = shape[0] * math.prod(shape[2:])
        out.append((name, shape, "uniform",
                    math.sqrt(2.0 / fan_out) * math.sqrt(3)))

    def const(name, shape, value):
        out.append((name, shape, "const", value))

    def norm(name, c):
        const(f"{name}.weight", (c,), 1.0)
        const(f"{name}.bias", (c,), 0.0)

    conv("patch_embed.proj.weight", (d0, 3, p, p))
    const("patch_embed.proj.bias", (d0,), 0.0)
    norm("patch_embed.norm", d0)
    n_stages = len(cfg["depths"])
    for i, j, dim in _block_dims(cfg):
        b = f"layers.{i}.blocks.{j}"
        half, d_inner, r = ss2d_sizes(dim, n)
        norm(f"{b}.ln_1", half)
        a = f"{b}.self_attention"
        out.append((f"{a}.x_proj_weight", (4, r + 2 * n, d_inner), "uniform",
                    d_inner ** -0.5))
        out.append((f"{a}.dt_projs_weight", (4, d_inner, r), "uniform",
                    r ** -0.5))
        out.append((f"{a}.dt_projs_bias", (4, d_inner), "dt_bias", 0.0))
        out.append((f"{a}.A_logs", (4 * d_inner, n), "a_log", 0.0))
        const(f"{a}.Ds", (4 * d_inner,), 1.0)
        trunc02(f"{a}.in_proj.weight", (2 * d_inner, half))
        conv(f"{a}.conv2d.weight", (d_inner, 1, 3, 3))
        const(f"{a}.conv2d.bias", (d_inner,), 0.0)
        norm(f"{a}.out_norm", d_inner)
        trunc02(f"{a}.out_proj.weight", (half, d_inner))
        for k, kind in ((0, "bn"), (1, 3), (2, "bn"), (4, 3), (5, "bn"),
                        (7, 1)):
            if kind == "bn":
                norm(f"{b}.{BRANCH}.{k}", half)
            else:
                conv(f"{b}.{BRANCH}.{k}.weight", (half, half, kind, kind))
                const(f"{b}.{BRANCH}.{k}.bias", (half,), 0.0)
        if j == cfg["depths"][i] - 1 and i < n_stages - 1:
            norm(f"layers.{i}.downsample.norm", 4 * dim)
            trunc02(f"layers.{i}.downsample.reduction.weight",
                    (2 * dim, 4 * dim))
    trunc02("head.weight", (cfg["num_classes"], cfg["dims"][-1]))
    const("head.bias", (cfg["num_classes"],), 0.0)
    return out


def batch_norm_buffers(cfg: dict, device) -> Params:
    """The BatchNorm running statistics as a fresh model holds them."""
    out = {}
    for i, j, dim in _block_dims(cfg):
        half = dim // 2
        for k in (0, 2, 5):
            b = f"layers.{i}.blocks.{j}.{BRANCH}.{k}"
            out[f"{b}.running_mean"] = torch.zeros(half, device=device)
            out[f"{b}.running_var"] = torch.ones(half, device=device)
            out[f"{b}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
    return out


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every parameter, float32 on ``device``, from ``seed``: one uniform
    draw of all of them from a generator on ``device``, then one affine map
    that gives each leaf its scale (the model's initialisers' standard
    deviations, as uniforms) or its constant; the time-step biases and
    A_logs take their own maps. Views of one buffer, one leaf each."""
    spec = leaves(cfg)
    sizes = [math.prod(s) for _, s, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    idx = torch.repeat_interleave(torch.arange(len(spec), device=device),
                                  torch.tensor(sizes, device=device))
    scale = torch.tensor([s if k == "uniform" else 0.0
                          for _, _, k, s in spec], device=device)[idx]
    shift = torch.tensor([s if k == "const" else 0.0
                          for _, _, k, s in spec], device=device)[idx]
    u = flat.clone()
    flat.mul_(2).sub_(1).mul_(scale).add_(shift)
    out = {}
    for (name, shape, kind, _), part, raw in zip(
            spec, flat.split(sizes), u.split(sizes)):
        if kind == "dt_bias":
            dt = torch.exp(raw * (math.log(DT_MAX) - math.log(DT_MIN))
                           + math.log(DT_MIN)).clamp_min(DT_FLOOR)
            part.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif kind == "a_log":
            part.copy_(torch.log(torch.arange(
                1, shape[1] + 1, dtype=torch.float32, device=device)
                ).repeat(shape[0]))
        out[name] = part.view(shape)
    return out


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


def rotate_flip(x: torch.Tensor, angles: torch.Tensor,
                flip: torch.Tensor) -> torch.Tensor:
    """Per image of a float NHWC batch: a horizontal flip where ``flip``,
    then a rotation by ``angles`` (radians) about the centre, nearest
    neighbour (coordinates rounded half to even), zero fill."""
    b, h, w, _ = x.shape
    dev = x.device
    s = torch.sin(angles.float())[:, None, None]
    c = torch.cos(angles.float())[:, None, None]
    yy = (torch.arange(h, dtype=torch.float32, device=dev)
          - (h - 1) / 2.0)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev)
          - (w - 1) / 2.0)[None, None, :]
    src_y = torch.round(c * yy + s * xx + (h - 1) / 2.0).long()
    src_x = torch.round(-s * yy + c * xx + (w - 1) / 2.0).long()
    inside = (src_y >= 0) & (src_y < h) & (src_x >= 0) & (src_x < w)
    src_y, src_x = src_y.clamp(0, h - 1), src_x.clamp(0, w - 1)
    src_x = torch.where(flip[:, None, None], w - 1 - src_x, src_x)
    out = x[torch.arange(b, device=dev)[:, None, None], src_y, src_x]
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def preprocess(images_u8: torch.Tensor, image_size: int, *,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """uint8 NHWC -> float32 in [-1, 1]; with ``gen``, the training
    augmentation first (flip with probability 1/2, rotation uniform in
    +/-10 degrees). The benchmark feeds batches at the model's size, so no
    resize is needed; another size is refused."""
    if images_u8.shape[1:3] != (image_size, image_size):
        raise ValueError(f"the reference takes {image_size}^2 batches, got "
                         f"{tuple(images_u8.shape)}")
    x = images_u8.float()
    if gen is not None:
        b = x.shape[0]
        flip = torch.rand(b, generator=gen, device=gen.device) < 0.5
        angles = (2.0 * torch.rand(b, generator=gen, device=gen.device)
                  - 1.0) * math.radians(MAX_ROTATE_DEG)
        x = rotate_flip(x, angles.to(x.device), flip.to(x.device))
    return (x / 255.0 - 0.5) / 0.5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def scan(u, delta, A, B, C, D, bias):
    """Selective scan of K directions, float32.

    u, delta (b, K, Di, L); A (K, Di, N) (negative); B, C (b, K, N, L);
    D, bias (K, Di). dt = softplus(delta + bias); per step
    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t; y_t = C_t . h_t + D u_t.
    Returns y (b, K, Di, L).

    The recurrence runs in two levels of sequential steps, so that a
    Python loop of about 3 sqrt(L) steps covers L: the sequence is cut
    into chunks of T; every chunk walks its own T steps from a zero state,
    keeping the product P_t of its decays; the chunks' entry states are
    then walked chunk by chunk; and h_t = local_t + P_t h_entry. Each
    product and sum is a float32 operation of the same recurrence."""
    dt = F.softplus(delta + bias[None, :, :, None])
    b, k, di, L = u.shape
    t_len = max(1, math.isqrt(L - 1) + 1)
    n_chunks = -(-L // t_len)
    pad = n_chunks * t_len - L
    # step-major (L, b, K, Di, N); the padded steps decay by 1, inject 0
    dt_l = F.pad(dt, (0, pad)).permute(3, 0, 1, 2).unsqueeze(-1)
    u_l = F.pad(u, (0, pad)).permute(3, 0, 1, 2).unsqueeze(-1)
    b_l = F.pad(B, (0, pad)).permute(3, 0, 1, 2).unsqueeze(3)
    decay = torch.exp(dt_l * A)
    inject = dt_l * u_l * b_l
    shape = (n_chunks, t_len) + decay.shape[1:]
    # unbind, not indexing: the backward stacks the steps' gradients once
    a_steps = decay.reshape(shape).unbind(1)
    x_steps = inject.reshape(shape).unbind(1)
    h = torch.zeros_like(a_steps[0])
    p = torch.ones_like(a_steps[0])
    local, prod = [], []
    for a_t, x_t in zip(a_steps, x_steps):
        h = a_t * h + x_t
        p = a_t * p
        local.append(h)
        prod.append(p)
    local = torch.stack(local, 1)                  # (chunks, T, b, K, Di, N)
    prod = torch.stack(prod, 1)
    entry = torch.zeros_like(local[0, 0])
    entries = []
    for last, decay_all in zip(local[:, -1].unbind(0),
                               prod[:, -1].unbind(0)):
        entries.append(entry)
        entry = last + decay_all * entry
    states = local + prod * torch.stack(entries)[:, None]
    states = states.reshape((n_chunks * t_len,) + states.shape[2:])[:L]
    c_l = C.permute(3, 0, 1, 2).unsqueeze(3)       # (L, b, K, 1, N)
    y = (states * c_l).sum(-1).permute(1, 2, 3, 0)
    return y + D[None, :, :, None] * u


def scan_in_rows(u, delta, A, B, C, D, bias, rows: int):
    """:func:`scan` ``rows`` batch rows at a time (the scan is row by row
    independent); under autograd each part is recomputed in the backward,
    so only one part's steps are held at a time."""
    parts = []
    for i in range(0, u.shape[0], rows):
        args = (u[i:i + rows], delta[i:i + rows], A, B[i:i + rows],
                C[i:i + rows], D, bias)
        parts.append(checkpoint(scan, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else scan(*args))
    return torch.cat(parts)


def _q(quant, x):
    return x if quant is None else quant(x)


def _out(quant, y):
    return y if quant is None else quant.output(y)


def _product(quant, y):
    """A product's result: rounded, its gradient rounded for the
    backward's products."""
    return _out(quant, _q(quant, y))


def linear(x, w, bias=None, quant=None):
    return _product(quant, F.linear(_q(quant, x), _q(quant, w), bias))


def conv2d(x, w, bias, quant=None, **kw):
    return _product(quant, F.conv2d(_q(quant, x), _q(quant, w), bias,
                                    **kw))


def layer_norm(x, P, name, quant=None):
    return _q(quant, F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                                  P[f"{name}.bias"], LN_EPS))


def batch_norm(x, P, name, train: bool, quant=None):
    """NCHW BatchNorm: in train mode the batch's mean and biased
    variance, else the running statistics."""
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    inv = torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]
    return _q(quant, (x - mean[None, :, None, None])
              * inv[None, :, None, None]
              + P[f"{name}.bias"][None, :, None, None])


def ss2d(x, P, a, d_state, quant=None):
    """SS2D on NHWC x: in_proj -> (x, z); depthwise 3x3 conv + SiLU; the
    four scan orders (row-major, column-major and their reversals); the
    per-direction projections to dt, B, C; the scan; the orders merged
    back and summed; out_norm; gate with SiLU(z); out_proj."""
    b, h, w, _ = x.shape
    L = h * w
    xz = linear(x, P[f"{a}.in_proj.weight"], quant=quant)
    x, z = xz.chunk(2, dim=-1)
    d_inner = x.shape[-1]
    x = _q(quant, F.silu(conv2d(x.permute(0, 3, 1, 2),
                                P[f"{a}.conv2d.weight"],
                                P[f"{a}.conv2d.bias"], quant, padding=1,
                                groups=d_inner)))
    rows = x.reshape(b, d_inner, L)
    cols = x.transpose(2, 3).reshape(b, d_inner, L)
    fwd = torch.stack([rows, cols], dim=1)
    xs = torch.cat([fwd, fwd.flip(-1)], dim=1)                # (b, 4, Di, L)
    wx = P[f"{a}.x_proj_weight"]
    r = P[f"{a}.dt_projs_weight"].shape[-1]
    x_dbl = _product(quant, torch.einsum("bkdl,kcd->bkcl", _q(quant, xs),
                                         _q(quant, wx)))
    dts, Bs, Cs = torch.split(x_dbl, [r, d_state, d_state], dim=2)
    dts = _product(quant, torch.einsum(
        "bkrl,kdr->bkdl", _q(quant, dts),
        _q(quant, P[f"{a}.dt_projs_weight"])))
    A = -torch.exp(P[f"{a}.A_logs"]).reshape(4, d_inner, d_state)
    y = _q(quant, scan_in_rows(xs, dts, A, Bs, Cs,
                               P[f"{a}.Ds"].reshape(4, d_inner),
                               P[f"{a}.dt_projs_bias"], SCAN_ROWS))
    y_rows = y[:, 0] + y[:, 2].flip(-1)
    y_cols = y[:, 1] + y[:, 3].flip(-1)
    y_cols = y_cols.reshape(b, d_inner, w, h).transpose(2, 3).reshape(
        b, d_inner, L)
    y = _q(quant, y_rows + y_cols).transpose(1, 2).reshape(b, h, w,
                                                           d_inner)
    y = _q(quant, layer_norm(y, P, f"{a}.out_norm", quant)
           * _q(quant, F.silu(z)))
    return linear(y, P[f"{a}.out_proj.weight"], quant=quant)


def block(x, P, b, d_state, train: bool, keep, rate, quant=None):
    """SS_Conv_SSM: the right half through LayerNorm, SS2D and DropPath,
    the left half through BN-conv3x3-BN-ReLU-conv3x3-BN-ReLU-conv1x1-ReLU,
    concatenated (left, right), channel-shuffled in two groups, plus x."""
    left, right = x.chunk(2, dim=-1)
    r = ss2d(layer_norm(right, P, f"{b}.ln_1", quant), P,
             f"{b}.self_attention", d_state, quant)
    if keep is not None:
        r = torch.where(keep[:, None, None, None],
                        _q(quant, r / (1.0 - rate)), torch.zeros_like(r))
    c = left.permute(0, 3, 1, 2)
    br = f"{b}.{BRANCH}"
    c = batch_norm(c, P, f"{br}.0", train, quant)
    c = conv2d(c, P[f"{br}.1.weight"], P[f"{br}.1.bias"], quant, padding=1)
    c = F.relu(batch_norm(c, P, f"{br}.2", train, quant))
    c = conv2d(c, P[f"{br}.4.weight"], P[f"{br}.4.bias"], quant, padding=1)
    c = F.relu(batch_norm(c, P, f"{br}.5", train, quant))
    c = F.relu(conv2d(c, P[f"{br}.7.weight"], P[f"{br}.7.bias"], quant))
    c = c.permute(0, 2, 3, 1)
    # concat + channel_shuffle(2): out[..., 2j] = c[..., j],
    # out[..., 2j + 1] = r[..., j]
    return _q(quant, torch.stack([c, r], dim=-1).reshape(x.shape) + x)


def patch_merging(x, P, name, quant=None):
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    return linear(layer_norm(x, P, f"{name}.norm", quant),
                  P[f"{name}.reduction.weight"], quant=quant)


def forward(P: Params, images_u8: torch.Tensor, cfg: dict, *,
            train: bool, gen: Optional[torch.Generator] = None,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """Logits (b, num_classes) of a uint8 NHWC batch. In train mode the
    augmentation and DropPath draw from ``gen`` and BatchNorm uses the
    batch's statistics."""
    x = preprocess(images_u8, cfg["image_size"], gen=gen if train else None)
    p = cfg["patch_size"]
    x = conv2d(x.permute(0, 3, 1, 2), P["patch_embed.proj.weight"],
               P["patch_embed.proj.bias"], quant, stride=p)
    x = layer_norm(x.permute(0, 2, 3, 1), P, "patch_embed.norm", quant)
    rates = drop_path_rates(cfg)
    k = 0
    n_stages = len(cfg["depths"])
    for i, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            rate = rates[k]
            k += 1
            keep = None
            if train and rate > 0.0:
                keep = torch.rand(x.shape[0], generator=gen,
                                  device=gen.device) < 1.0 - rate
                keep = keep.to(x.device)
            x = block(x, P, f"layers.{i}.blocks.{j}", cfg["d_state"],
                      train, keep, rate, quant)
        if i < n_stages - 1:
            x = patch_merging(x, P, f"layers.{i}.downsample", quant)
    return linear(_q(quant, x.mean(dim=(1, 2))), P["head.weight"],
                  P["head.bias"], quant)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@torch.no_grad()
def adamw_step(P: Params, grads: Params, state: dict, step: int, lr: float,
               weight_decay: float, betas=(0.9, 0.999), eps=1e-8) -> None:
    """One AdamW update of every parameter in ``grads``, in place:
    p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps), with the moments
    in ``state`` (made at the first step)."""
    b1, b2 = betas
    for name, g in grads.items():
        m, v = state.setdefault(name, (torch.zeros_like(g),
                                       torch.zeros_like(g)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m / (1 - b1 ** step)
        v_hat = v / (1 - b2 ** step)
        p = P[name]
        p.mul_(1 - lr * weight_decay)
        p.sub_(lr * m_hat / (v_hat.sqrt() + eps))


def train_steps(P0: Params, batches: Sequence[Tuple[torch.Tensor,
                                                    torch.Tensor]],
                cfg: dict, *, gen: torch.Generator, lr: float,
                weight_decay: float, quant: Optional[Callable] = None):
    """Train a copy of ``P0`` on ``batches`` (uint8 images, int labels),
    one AdamW step each, with mean cross-entropy. Returns (losses, the
    first step's gradients, the parameters after the last step)."""
    P = {n: t.detach().clone().requires_grad_(True) for n, t in P0.items()}
    state, losses, first = {}, [], None
    for step, (images, labels) in enumerate(batches, start=1):
        logits = forward(P, images, cfg, train=True, gen=gen, quant=quant)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, list(P.values()))
        grads = dict(zip(P, grads))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        losses.append(float(loss.detach()))
        adamw_step(P, grads, state, step, lr, weight_decay)
    return losses, first, {n: t.detach() for n, t in P.items()}


@torch.no_grad()
def probabilities(P: Params, images_u8: torch.Tensor,
                  cfg: dict) -> torch.Tensor:
    """Softmax probabilities of an eval-mode forward."""
    return torch.softmax(forward(P, images_u8, cfg, train=False), -1)


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to the 8-bit float ``dtype`` with a per-tensor scale
    (its largest magnitude to the format's ``largest``)."""
    scale = x.abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).float() * scale


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Fp8Rounding:
    """The rounding of float8 training where the program trains in
    bfloat16: a tensor rounded to e4m3 in the forward (its gradient
    passes unchanged), and the gradient that reaches each product's
    result rounded to e5m2, the backward products' operand."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            q = _round(x.detach(), torch.float8_e4m3fn, 448.0)
        return x + (q - x).detach()

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _GradE5M2.apply(y) if y.requires_grad else y


FP8 = Fp8Rounding()
