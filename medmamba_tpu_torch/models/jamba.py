"""Jamba: a hybrid of Mamba-1 mixers and attention, as a causal language
model (AI21's Jamba family; Hugging Face ``JambaForCausalLM``).

The configuration is a dict with the keys of the model's ``config.json``
(``hidden_size``, ``intermediate_size``, ``num_hidden_layers``,
``attn_layer_period``, ``attn_layer_offset``, ``num_attention_heads``,
``num_key_value_heads``, ``mamba_d_state``, ``mamba_d_conv``,
``mamba_expand``, ``mamba_dt_rank``, ``mamba_conv_bias``,
``mamba_proj_bias``, ``rms_norm_eps``, ``vocab_size``, ``num_experts``,
``tie_word_embeddings``). Layer ``i`` mixes with attention where
``i % attn_layer_period == attn_layer_offset`` and with a Mamba-1 mixer
elsewhere, the rule of ``JambaConfig``; every layer has a SiLU-gated MLP
(``num_experts`` 1: no experts are routed).

* **The mixer** (``JambaMambaMixer``): ``in_proj`` to x and z; x through a
  causal depthwise conv1d and SiLU; ``x_proj`` to dt, B and C, each
  through its own RMSNorm; dt through ``dt_proj``'s weight, its bias going
  to the scan as ``delta_bias`` with softplus; the selective scan of
  ``ops.selective_scan`` (y + D u; K1 and K2 on the card, the plain scan on
  the CPU) on the scan's (b, d_inner, L) layout, with B and C as one group
  (b, 1, d_state, L); y gated by silu(z) outside the kernel; ``out_proj``.
* **Attention** (``JambaAttention``): query heads over ``num_key_value_heads``
  shared key/value heads, causal, no positional encoding, through
  ``F.scaled_dot_product_attention``.
* **The model**: the embedding, the layers (pre-norm residual blocks: norm,
  mixer, add; norm, MLP, add), a final RMSNorm and the LM head, tied to
  the embedding. ``forward(ids)`` gives float32 logits (b, L, vocab).

``dtype`` is the block dtype, as in ``models/vssm.py``: parameters stay
float32 and each layer casts its input and its parameters to it where it
uses them; RMSNorm statistics and affine are float32 and the result is in
the block dtype; the scan core is float32 and emits y in the block dtype;
the logits are the LM head's block-dtype product, cast to float32.

On the card each mixer, attention layer and MLP opens its forward with a
marker (``utils/tracing.py``: ``mixer.forward``, ``attention.forward``,
``mlp.forward``) and its backward with one (``mixer.backward``, ...,
launched when the gradient reaches the layer's output).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from medmamba_tpu_torch.ops.selective_scan import selective_scan
from medmamba_tpu_torch.utils import tracing

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4
INIT_STD = 0.02


def is_attention_layer(cfg: dict, i: int) -> bool:
    """Whether layer ``i`` mixes with attention (``JambaConfig``'s
    ``layers_block_type``)."""
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype,
             dim: int = -1) -> torch.Tensor:
    """RMSNorm over ``dim``: statistics and affine in float32, the result
    in ``dtype``."""
    x32 = x.float()
    inv = torch.rsqrt(x32.pow(2).mean(dim, keepdim=True) + eps)
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x32 * inv * weight.view(shape)).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype, dim: int = -1) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps, dtype, dim)


class MambaMixer(nn.Module):
    """Hugging Face's ``JambaMambaMixer`` on (b, L, hidden) inputs."""

    def __init__(self, cfg: dict, dtype=torch.float32):
        super().__init__()
        d = cfg["hidden_size"]
        di = cfg["mamba_expand"] * d
        n, r, k = cfg["mamba_d_state"], cfg["mamba_dt_rank"], \
            cfg["mamba_d_conv"]
        bias, eps = cfg["mamba_proj_bias"], cfg["rms_norm_eps"]
        self.dtype, self.sizes = dtype, (di, n, r, k)
        self.in_proj = nn.Linear(d, 2 * di, bias=bias)
        self.conv1d = nn.Conv1d(di, di, k, groups=di, padding=k - 1,
                                bias=cfg["mamba_conv_bias"])
        self.x_proj = nn.Linear(di, r + 2 * n, bias=False)
        self.dt_proj = nn.Linear(r, di, bias=True)
        self.A_log = nn.Parameter(torch.empty(di, n))
        self.D = nn.Parameter(torch.empty(di))
        self.out_proj = nn.Linear(di, d, bias=bias)
        self.dt_layernorm = RMSNorm(r, eps)
        self.b_layernorm = RMSNorm(n, eps)
        self.c_layernorm = RMSNorm(n, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt_ = self.dtype
        di, n, r, k = self.sizes
        tracing.mark("mixer.forward", x)
        length = x.shape[1]
        u, z = _linear(self.in_proj, x, dt_).chunk(2, dim=-1)
        conv = self.conv1d
        u = F.conv1d(u.transpose(1, 2), conv.weight.to(dt_),
                     None if conv.bias is None else conv.bias.to(dt_),
                     padding=k - 1, groups=di)[..., :length]
        u = F.silu(u)                                       # (b, di, L)
        # x_proj and dt_proj on the scan's layout: (out, in) @ (b, in, L)
        dbc = torch.matmul(self.x_proj.weight.to(dt_), u)
        dt, B, C = dbc.split([r, n, n], dim=1)
        dt = self.dt_layernorm(dt, dt_, dim=1)
        B = self.b_layernorm(B, dt_, dim=1).unsqueeze(1)     # (b, 1, n, L)
        C = self.c_layernorm(C, dt_, dim=1).unsqueeze(1)
        delta = torch.matmul(self.dt_proj.weight.to(dt_), dt)
        y = selective_scan(u, delta, -torch.exp(self.A_log.float()), B, C,
                           self.D.float(), self.dt_proj.bias.float(),
                           delta_softplus=True, out_dtype=dt_)
        y = y.transpose(1, 2) * F.silu(z)
        out = _linear(self.out_proj, y, dt_)
        return tracing.mark_backward("mixer.backward", out)


class Attention(nn.Module):
    """Hugging Face's ``JambaAttention``: causal, grouped key/value heads,
    no positional encoding, scale 1/sqrt(head_dim)."""

    def __init__(self, cfg: dict, dtype=torch.float32):
        super().__init__()
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        kv = cfg["num_key_value_heads"]
        hd = d // h
        self.dtype, self.sizes = dtype, (h, kv, hd)
        self.q_proj = nn.Linear(d, h * hd, bias=False)
        self.k_proj = nn.Linear(d, kv * hd, bias=False)
        self.v_proj = nn.Linear(d, kv * hd, bias=False)
        self.o_proj = nn.Linear(h * hd, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt_ = self.dtype
        h, kv, hd = self.sizes
        tracing.mark("attention.forward", x)
        b, length, _ = x.shape

        def heads(layer, n):
            return _linear(layer, x, dt_).view(b, length, n, hd).transpose(
                1, 2)
        o = F.scaled_dot_product_attention(
            heads(self.q_proj, h), heads(self.k_proj, kv),
            heads(self.v_proj, kv), is_causal=True, enable_gqa=kv != h)
        out = _linear(self.o_proj, o.transpose(1, 2).reshape(
            b, length, h * hd), dt_)
        return tracing.mark_backward("attention.backward", out)


class MLP(nn.Module):
    """down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, cfg: dict, dtype=torch.float32):
        super().__init__()
        d, f = cfg["hidden_size"], cfg["intermediate_size"]
        self.dtype = dtype
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt_ = self.dtype
        tracing.mark("mlp.forward", x)
        y = F.silu(_linear(self.gate_proj, x, dt_)) * _linear(self.up_proj,
                                                              x, dt_)
        return tracing.mark_backward("mlp.backward",
                                     _linear(self.down_proj, y, dt_))


class JambaLayer(nn.Module):
    """Norm, mixer (Mamba or attention), residual; norm, MLP, residual."""

    def __init__(self, cfg: dict, i: int, dtype=torch.float32):
        super().__init__()
        eps = cfg["rms_norm_eps"]
        self.dtype = dtype
        self.input_layernorm = RMSNorm(cfg["hidden_size"], eps)
        if is_attention_layer(cfg, i):
            self.self_attn = Attention(cfg, dtype)
        else:
            self.mamba = MambaMixer(cfg, dtype)
        self.pre_ff_layernorm = RMSNorm(cfg["hidden_size"], eps)
        self.feed_forward = MLP(cfg, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mixer = getattr(self, "self_attn", None) or self.mamba
        x = x + mixer(self.input_layernorm(x, self.dtype))
        return x + self.feed_forward(self.pre_ff_layernorm(x, self.dtype))


class Jamba(nn.Module):
    """The causal language model of ``cfg``; ``forward(ids)`` gives float32
    logits. ``reset_parameters(generator)`` draws the published
    initialisation: normal(0, 0.02) for every linear, convolution and the
    embedding (biases 0), RMSNorm weights 1, ``A_log`` log(1..d_state) on
    every channel, D 1, and ``dt_proj``'s bias the inverse softplus of a
    time step drawn log-uniform in [0.001, 0.1]."""

    def __init__(self, cfg: dict, dtype=torch.float32):
        super().__init__()
        if cfg.get("num_experts", 1) != 1:
            raise ValueError("routed experts are not supported: "
                             f"num_experts {cfg['num_experts']}")
        if not cfg.get("tie_word_embeddings", True):
            raise ValueError("an untied LM head is not supported")
        self.config, self.dtype = dict(cfg), dtype
        self.embed_tokens = nn.Embedding(cfg["vocab_size"],
                                         cfg["hidden_size"])
        self.layers = nn.ModuleList(JambaLayer(cfg, i, dtype) for i in
                                    range(cfg["num_hidden_layers"]))
        self.final_layernorm = RMSNorm(cfg["hidden_size"],
                                       cfg["rms_norm_eps"])

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Embedding)):
                m.weight.normal_(0.0, INIT_STD, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
        # after the linears, whose pass zeroes dt_proj's bias
        for m in self.modules():
            if isinstance(m, MambaMixer):
                n = m.A_log.shape[1]
                m.A_log.copy_(torch.log(torch.arange(
                    1, n + 1, dtype=torch.float32)).expand_as(m.A_log))
                m.D.fill_(1.0)
                u = torch.rand(m.dt_proj.bias.shape, generator=generator,
                               device=m.D.device)
                m.dt_proj.bias.copy_(dt_bias(u))
        return self

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = F.embedding(ids, self.embed_tokens.weight).to(self.dtype)
        for layer in self.layers:
            x = layer(x)
        x = self.final_layernorm(x, self.dtype)
        return F.linear(x, self.embed_tokens.weight.to(self.dtype)).float()


def dt_bias(u: torch.Tensor) -> torch.Tensor:
    """The time-step bias from uniforms ``u`` in [0, 1): the inverse
    softplus of dt, log-uniform in [DT_MIN, DT_MAX] (floored at
    DT_FLOOR)."""
    dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                   + math.log(DT_MIN)).clamp_min(DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))
