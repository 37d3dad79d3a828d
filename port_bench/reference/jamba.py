"""The plain reference of the Jamba cells: AI21's Jamba causal language
model in float32 PyTorch.

Written from the published model (Hugging Face ``JambaForCausalLM``:
``JambaMambaMixer``, ``JambaAttention``, ``JambaMLP``, ``JambaRMSNorm``, the
decoder layers and the tied LM head; the configuration's keys as in its
``config.json``) and nothing of the program under test: it imports no
kernel, no module of the port and no JAX. It borrows from the VSSM
reference (``reference/vssm.py``) only what is plain: the two-level
sequential scan, AdamW and the float8 rounding of the control. Parameters
live in a flat dict keyed by the program's state-dict names, so the
benchmark hands the same weights to both sides.

Matrix products run in float32 without TF32: :func:`train_steps` turns
TF32 off for matrix products and cuDNN while it runs.

Departures from Hugging Face's Jamba, none of which changes the
mathematics of a training step:

* the layers are recomputed in the backward (``torch.utils.checkpoint``),
  the attention is computed a few heads at a time and the scan a block of
  channels at a time, and a batch one sequence at a time with the
  gradients summed, so that the reference fits on one card at 8192
  tokens;
* the scan is the two-level sequential recurrence of
  ``reference/vssm.py: scan`` in float32 (Hugging Face calls
  ``mamba_ssm``'s fused kernel, or a sequential loop);
* attention is the explicit softmax of the masked scores (Hugging Face
  calls ``scaled_dot_product_attention`` or flash attention);
* the loss is the mean next-token cross-entropy over every position but
  each sequence's last, as ``JambaForCausalLM`` computes it from
  ``labels=input_ids``; there is no padding, so no position is ignored.

``quant`` is the control's hook (``reference/vssm.py: FP8``): it rounds a
tensor wherever the program computes in its block dtype (each operand and
result of a product, each normalisation's and activation's result, the
scan's output, the residual stream), and its ``output`` the gradient that
reaches each product's result; None leaves everything float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.vssm import _product, _q, adamw_step
from port_bench.reference.vssm import scan as scan_k

Params = Dict[str, torch.Tensor]
INIT_STD = 0.02
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4
SCAN_CHANNELS = 1024       # channels the scan holds at a time
ATTENTION_HEADS = 4        # heads the attention holds at a time


def is_attention(cfg: dict, i: int) -> bool:
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def sizes(cfg: dict) -> Tuple[int, int, int, int, int]:
    """(hidden, d_inner, d_state, dt_rank, d_conv)."""
    d = cfg["hidden_size"]
    return (d, cfg["mamba_expand"] * d, cfg["mamba_d_state"],
            cfg["mamba_dt_rank"], cfg["mamba_d_conv"])


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter as (name, shape, kind). Kinds: ``normal`` (N(0,
    0.02)), ``zero``, ``one``, ``a_log`` (log 1..d_state on every
    channel), ``dt_bias`` (the inverse softplus of a time step drawn
    log-uniform in [0.001, 0.1])."""
    d, di, n, r, k = sizes(cfg)
    f, v = cfg["intermediate_size"], cfg["vocab_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    out = [("embed_tokens.weight", (v, d), "normal")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        out.append((f"{p}.input_layernorm.weight", (d,), "one"))
        if is_attention(cfg, i):
            a = f"{p}.self_attn"
            out += [(f"{a}.q_proj.weight", (h * hd, d), "normal"),
                    (f"{a}.k_proj.weight", (kv * hd, d), "normal"),
                    (f"{a}.v_proj.weight", (kv * hd, d), "normal"),
                    (f"{a}.o_proj.weight", (d, h * hd), "normal")]
        else:
            m = f"{p}.mamba"
            out += [(f"{m}.in_proj.weight", (2 * di, d), "normal"),
                    (f"{m}.conv1d.weight", (di, 1, k), "normal")]
            if cfg["mamba_conv_bias"]:
                out.append((f"{m}.conv1d.bias", (di,), "zero"))
            out += [(f"{m}.x_proj.weight", (r + 2 * n, di), "normal"),
                    (f"{m}.dt_proj.weight", (di, r), "normal"),
                    (f"{m}.dt_proj.bias", (di,), "dt_bias"),
                    (f"{m}.A_log", (di, n), "a_log"),
                    (f"{m}.D", (di,), "one"),
                    (f"{m}.out_proj.weight", (d, di), "normal"),
                    (f"{m}.dt_layernorm.weight", (r,), "one"),
                    (f"{m}.b_layernorm.weight", (n,), "one"),
                    (f"{m}.c_layernorm.weight", (n,), "one")]
        out.append((f"{p}.pre_ff_layernorm.weight", (d,), "one"))
        ff = f"{p}.feed_forward"
        out += [(f"{ff}.gate_proj.weight", (f, d), "normal"),
                (f"{ff}.up_proj.weight", (f, d), "normal"),
                (f"{ff}.down_proj.weight", (d, f), "normal")]
    out.append(("final_layernorm.weight", (d,), "one"))
    return out


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaves(cfg))


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every parameter, float32 on ``device``, from ``seed``: one normal
    draw of all of them from a generator on ``device`` times 0.02, then one
    uniform draw for the time-step biases; the other kinds are constants.
    Views of one buffer, one leaf each."""
    spec = leaves(cfg)
    shapes = [s for _, s, _ in spec]
    numel = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(numel), generator=gen, device=device)
    flat.mul_(INIT_STD)
    out = {}
    for (name, shape, kind), part in zip(spec, flat.split(numel)):
        if kind == "zero":
            part.zero_()
        elif kind == "one":
            part.fill_(1.0)
        elif kind == "a_log":
            part.copy_(torch.log(torch.arange(
                1, shape[1] + 1, dtype=torch.float32, device=device)
                ).repeat(shape[0]))
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                           + math.log(DT_MIN)).clamp_min(DT_FLOOR)
            part.copy_(dt + torch.log(-torch.expm1(-dt)))
        out[name] = part.view(shape)
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def linear(x, w, quant=None):
    return _product(quant, F.linear(_q(quant, x), _q(quant, w)))


def rms_norm(x, w, eps, quant=None):
    """x / sqrt(mean(x^2) + eps) * w over the last axis."""
    return _q(quant, x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
              * w)


def scan(u, delta, A, B, C, D, bias):
    """The selective scan of one group: u, delta (b, Di, L); A (Di, N);
    B, C (b, N, L); D, bias (Di,). dt = softplus(delta + bias),
    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t, y_t = C_t . h_t + D u_t;
    ``reference/vssm.py: scan`` on ``SCAN_CHANNELS`` channels at a time,
    each block recomputed in the backward."""
    parts = []
    for c in range(0, u.shape[1], SCAN_CHANNELS):
        s = slice(c, c + SCAN_CHANNELS)
        args = (u[:, None, s], delta[:, None, s], A[None, s], B[:, None],
                C[:, None], D[None, s], bias[None, s])
        parts.append((checkpoint(scan_k, *args, use_reentrant=False)
                      if torch.is_grad_enabled() else scan_k(*args))[:, 0])
    return torch.cat(parts, dim=1)


def mamba(x, P, m, cfg, quant=None):
    """Hugging Face's ``JambaMambaMixer`` on (b, L, hidden)."""
    d, di, n, r, k = sizes(cfg)
    eps = cfg["rms_norm_eps"]
    length = x.shape[1]
    u, z = linear(x, P[f"{m}.in_proj.weight"], quant).chunk(2, dim=-1)
    bias = P.get(f"{m}.conv1d.bias")
    u = _product(quant, F.conv1d(_q(quant, u.transpose(1, 2)),
                                 _q(quant, P[f"{m}.conv1d.weight"]),
                                 None if bias is None else bias,
                                 padding=k - 1, groups=di))[..., :length]
    u = _q(quant, F.silu(u))                                  # (b, di, L)
    dt, B, C = linear(u.transpose(1, 2), P[f"{m}.x_proj.weight"],
                      quant).split([r, n, n], dim=-1)
    dt = rms_norm(dt, P[f"{m}.dt_layernorm.weight"], eps, quant)
    B = rms_norm(B, P[f"{m}.b_layernorm.weight"], eps, quant)
    C = rms_norm(C, P[f"{m}.c_layernorm.weight"], eps, quant)
    delta = linear(dt, P[f"{m}.dt_proj.weight"], quant)       # no bias
    y = scan(u, delta.transpose(1, 2), -torch.exp(P[f"{m}.A_log"]),
             B.transpose(1, 2), C.transpose(1, 2), P[f"{m}.D"],
             P[f"{m}.dt_proj.bias"])
    y = _q(quant, _q(quant, y).transpose(1, 2) * _q(quant, F.silu(z)))
    return linear(y, P[f"{m}.out_proj.weight"], quant)


def _heads(q, k, v):
    """Causal softmax attention of a block of heads (b, h, L, hd)."""
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    length = q.shape[-2]
    mask = torch.ones(length, length, dtype=torch.bool,
                      device=q.device).triu(1)
    return torch.softmax(scores.masked_fill(mask, float("-inf")), -1) @ v


def attention(x, P, a, cfg, quant=None):
    """Hugging Face's ``JambaAttention``: ``num_attention_heads`` query
    heads over ``num_key_value_heads`` shared key/value heads, causal, no
    positional encoding, scale 1/sqrt(head_dim); ``ATTENTION_HEADS`` heads
    at a time, each block recomputed in the backward."""
    b, length, d = x.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h

    def heads(name, n):
        return _q(quant, linear(x, P[f"{a}.{name}.weight"], quant)).view(
            b, length, n, hd).transpose(1, 2)
    q, k, v = heads("q_proj", h), heads("k_proj", kv), heads("v_proj", kv)
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    parts = []
    for s in range(0, h, ATTENTION_HEADS):
        args = (q[:, s:s + ATTENTION_HEADS], k[:, s:s + ATTENTION_HEADS],
                v[:, s:s + ATTENTION_HEADS])
        parts.append(checkpoint(_heads, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _heads(*args))
    o = _q(quant, torch.cat(parts, dim=1)).transpose(1, 2).reshape(
        b, length, h * hd)
    return linear(o, P[f"{a}.o_proj.weight"], quant)


def layer(x, P, i, cfg, quant=None):
    """One decoder layer: x + mixer(norm(x)), then + MLP(norm(.))."""
    p, eps = f"layers.{i}", cfg["rms_norm_eps"]
    h = rms_norm(x, P[f"{p}.input_layernorm.weight"], eps, quant)
    h = (attention(h, P, f"{p}.self_attn", cfg, quant) if is_attention(cfg, i)
         else mamba(h, P, f"{p}.mamba", cfg, quant))
    x = _q(quant, x + h)
    h = rms_norm(x, P[f"{p}.pre_ff_layernorm.weight"], eps, quant)
    ff = f"{p}.feed_forward"
    h = _q(quant, _q(quant, F.silu(linear(h, P[f"{ff}.gate_proj.weight"],
                                          quant)))
           * linear(h, P[f"{ff}.up_proj.weight"], quant))
    return _q(quant, x + linear(h, P[f"{ff}.down_proj.weight"], quant))


def forward(P: Params, ids: torch.Tensor, cfg: dict, *,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """Float32 logits (b, L, vocab) of (b, L) token ids; under autograd
    each layer is recomputed in the backward."""
    x = _q(quant, F.embedding(ids, P["embed_tokens.weight"]))
    for i in range(cfg["num_hidden_layers"]):
        x = (checkpoint(layer, x, P, i, cfg, quant, use_reentrant=False)
             if torch.is_grad_enabled() else layer(x, P, i, cfg, quant))
    x = rms_norm(x, P["final_layernorm.weight"], cfg["rms_norm_eps"], quant)
    return linear(x, P["embed_tokens.weight"], quant)


def loss_sum(P: Params, ids: torch.Tensor, cfg: dict,
             quant: Optional[Callable] = None) -> torch.Tensor:
    """The summed next-token cross-entropy of (b, L) ids over every
    position but each sequence's last."""
    logits = forward(P, ids, cfg, quant=quant)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           ids[:, 1:].reshape(-1), reduction="sum")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_and_grads(P: Params, ids: torch.Tensor, cfg: dict,
                   quant: Optional[Callable] = None
                   ) -> Tuple[float, Params]:
    """The mean next-token loss of (b, L) ids and its gradient by
    parameter, one sequence at a time, the sequences' parts summed."""
    count = ids.shape[0] * (ids.shape[1] - 1)
    names = list(P)
    total, grads = 0.0, None
    for row in ids.split(1):
        loss = loss_sum(P, row, cfg, quant) / count
        g = torch.autograd.grad(loss, [P[n] for n in names])
        total += float(loss.detach())
        grads = list(g) if grads is None else [a.add_(b) for a, b in
                                               zip(grads, g)]
        del g, loss
    return total, dict(zip(names, grads))


def train_steps(P0: Params, batches: Sequence[torch.Tensor], cfg: dict, *,
                lr: float, weight_decay: float,
                quant: Optional[Callable] = None):
    """Train a copy of ``P0`` on ``batches`` of (b, L) ids, one AdamW step
    each, with float32 matrix products. Returns (losses, the first step's
    gradients, the parameters after the last step)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        P = {n: t.detach().clone().requires_grad_(True)
             for n, t in P0.items()}
        state, losses, first = {}, [], None
        for step, ids in enumerate(batches, start=1):
            loss, grads = loss_and_grads(P, ids, cfg, quant)
            if first is None:
                first = {n: g.clone() for n, g in grads.items()}
            losses.append(loss)
            adamw_step(P, grads, state, step, lr, weight_decay)
            del grads
        return losses, first, {n: t.detach() for n, t in P.items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
