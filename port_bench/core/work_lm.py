"""The benchmark's own count of a Jamba language model's work, as
``core/work.py`` counts the VSSM's: written from the configuration's
shapes, not imported from the program, 2 FLOPs a multiply-accumulate, a
training step counted as three forwards (the backward as two), recomputed
work not counted. The peaks are ``core/work.py``'s.

Counted per token: every projection (``in_proj``, the depthwise conv1d,
``x_proj``, ``dt_proj``, ``out_proj``; q, k, v and o), the selective scan
(``work.scan_macs``), the MLP's three products and the tied LM head; per
sequence, causal attention's two products over the keys at or before
each query, L (L + 1) / 2 query-key pairs a head. Norms, activations, the
gate and the loss are left out.

The scan's launches (:func:`scan_launches`): one K1 in each Mamba mixer's
forward and one K2 in its backward, with each input byte read once and
each output byte written once, as ``work.scan_launches`` counts them.
What a design keeps between the two (K1's tile-entry states) is left
out: it is work the kernels could avoid.
"""
from __future__ import annotations

from typing import Dict, List

from port_bench.core import work


def _is_attention(cfg: dict, i: int) -> bool:
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def layer_kinds(cfg: dict) -> List[str]:
    return ["attention" if _is_attention(cfg, i) else "mamba"
            for i in range(cfg["num_hidden_layers"])]


def mamba_macs(cfg: dict, tokens: int) -> float:
    """MACs of one Mamba mixer over ``tokens`` tokens."""
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    n, r, k = cfg["mamba_d_state"], cfg["mamba_dt_rank"], \
        cfg["mamba_d_conv"]
    per_token = (d * 2 * di + di * k + di * (r + 2 * n) + r * di + di * d)
    return float(per_token * tokens) + work.scan_macs(1, tokens, di, n)


def attention_macs(cfg: dict, batch: int, seq_len: int) -> float:
    """MACs of one causal attention layer over ``batch`` sequences."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, kv = d // h, cfg["num_key_value_heads"]
    proj = d * h * hd * 2 + d * kv * hd * 2
    pairs = seq_len * (seq_len + 1) // 2
    return float(batch * (proj * seq_len + 2 * h * hd * pairs))


def step_flops(cfg: dict, batch: int, seq_len: int,
               train: bool = True) -> float:
    """FLOPs of a forward (or, with ``train``, a training step) over
    ``batch`` sequences of ``seq_len`` tokens, 2 per MAC."""
    tokens = batch * seq_len
    d = cfg["hidden_size"]
    mlp = 3.0 * d * cfg["intermediate_size"] * tokens
    macs = float(d * cfg["vocab_size"] * tokens)          # the LM head
    for kind in layer_kinds(cfg):
        macs += mlp + (attention_macs(cfg, batch, seq_len)
                       if kind == "attention" else mamba_macs(cfg, tokens))
    return 2.0 * macs * (work.TRAIN_FORWARDS if train else 1)


def scan_launches(cfg: dict, batch: int, seq_len: int, block_dtype: str
                  ) -> List[Dict[str, float]]:
    """Per Mamba mixer, its K1's and K2's bytes and FLOPs on ``batch``
    sequences of ``seq_len`` tokens (one group: B and C (b, 1, N, L)).

    K1 reads u and delta (b, Di, L) and B and C in the block dtype, A
    (Di, N), D and the dt bias in float32, and writes y (b, Di, L) in the
    block dtype. K2 reads those inputs and y's gradient and writes a
    gradient of each input. K2's FLOPs are counted as twice K1's."""
    e = work.DTYPE_BYTES[block_dtype]
    d = cfg["hidden_size"]
    di, n = cfg["mamba_expand"] * d, cfg["mamba_d_state"]
    act = batch * di * seq_len * e
    bc = batch * n * seq_len * e
    params = (di * n + 2 * di) * 4
    fwd_bytes = 2 * act + 2 * bc + params + act
    bwd_bytes = fwd_bytes + (2 * act + 2 * bc + params)
    fwd_flops = 2.0 * work.scan_macs(batch, seq_len, di, n)
    launch = dict(fwd_bytes=fwd_bytes, fwd_flops=fwd_flops,
                  bwd_bytes=bwd_bytes, bwd_flops=2 * fwd_flops)
    return [dict(launch) for kind in layer_kinds(cfg) if kind == "mamba"]


def scan_bound_s(cfg: dict, batch: int, seq_len: int, block_dtype: str,
                 which: str) -> float:
    """The least time the card could take for a step's K1s (``which``
    "fwd") or K2s ("bwd"): each launch's bytes over the memory bandwidth
    or its FLOPs at the float32 peak, whichever bounds it."""
    return sum(work.bound_s(x[which + "_flops"], x[which + "_bytes"],
                            work.PEAK_FLOPS["float32"])
               for x in scan_launches(cfg, batch, seq_len, block_dtype))
