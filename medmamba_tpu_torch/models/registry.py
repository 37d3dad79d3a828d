"""Model registry: the VSSM sizes T / S / B / Te (counterpart of
``medmamba_tpu/models/registry.py``) and the language models of
``models/jamba.py`` by name (:func:`create_lm`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from medmamba_tpu_torch.models.jamba import Jamba
from medmamba_tpu_torch.models.vssm import VSSM
from medmamba_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class VSSMConfig:
    depths: Sequence[int]
    dims: Sequence[int]
    d_state: int = 16
    drop_path_rate: float = 0.1


MODEL_CONFIGS = {
    "T": VSSMConfig(depths=(2, 2, 4, 2), dims=(96, 192, 384, 768)),
    "S": VSSMConfig(depths=(2, 2, 8, 2), dims=(96, 192, 384, 768)),
    "B": VSSMConfig(depths=(2, 2, 12, 2), dims=(128, 256, 512, 1024)),
    "Te": VSSMConfig(depths=(2, 3, 3, 2), dims=(96, 192, 384, 768)),
}


def create_model(size: str = "T", num_classes: int = 1000, *,
                 attn_drop_rate: float = 0.0, drop_rate: float = 0.0,
                 dtype=torch.float32, scan_impl: str = "auto",
                 use_checkpoint: bool = False, scan_tau=None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> VSSM:
    """Build a VSSM of the given size on ``device`` (``cuda`` by default;
    raises without a card unless ``device="cpu"``). ``dtype`` is the block
    dtype (parameters stay float32); ``use_checkpoint`` recomputes each
    block's activations in the backward."""
    dev = resolve_device(device)
    cfg = MODEL_CONFIGS[size]
    model = VSSM(num_classes=num_classes, depths=cfg.depths, dims=cfg.dims,
                 d_state=cfg.d_state, drop_path_rate=cfg.drop_path_rate,
                 attn_drop_rate=attn_drop_rate, drop_rate=drop_rate,
                 scan_impl=scan_impl, scan_tau=scan_tau, generator=generator,
                 dtype=dtype, use_checkpoint=use_checkpoint)
    return model.to(dev)


def medmamba_t(num_classes=1000, **kw):
    return create_model("T", num_classes, **kw)


def medmamba_s(num_classes=1000, **kw):
    return create_model("S", num_classes, **kw)


def medmamba_b(num_classes=1000, **kw):
    return create_model("B", num_classes, **kw)


def medmamba_te(num_classes=1000, **kw):
    return create_model("Te", num_classes, **kw)


# AI21-Jamba2-3B's config.json
# (https://huggingface.co/ai21labs/AI21-Jamba2-3B/blob/main/config.json),
# the keys that set its shape
JAMBA2_3B = {
    "attn_layer_offset": 7, "attn_layer_period": 14,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_act": "silu", "hidden_size": 2560, "intermediate_size": 8192,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
    "mamba_dt_rank": 160, "mamba_expand": 2, "mamba_proj_bias": False,
    "num_attention_heads": 20, "num_experts": 1, "num_experts_per_tok": 1,
    "num_hidden_layers": 28, "num_key_value_heads": 1,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": True, "vocab_size": 65536,
}
LM_CONFIGS = {"jamba2_3b": JAMBA2_3B}


def lm_config(name: str = "jamba2_3b", config: Optional[dict] = None, *,
              num_hidden_layers: Optional[int] = None) -> dict:
    """The configuration of the language model ``name``, with the keys of
    ``config`` over it and, where given, ``num_hidden_layers``."""
    if name not in LM_CONFIGS:
        raise ValueError(f"unknown language model {name!r}; known: "
                         f"{sorted(LM_CONFIGS)}")
    cfg = {**LM_CONFIGS[name], **(config or {})}
    if num_hidden_layers is not None:
        cfg["num_hidden_layers"] = num_hidden_layers
    return cfg


def create_lm(name: str = "jamba2_3b", config: Optional[dict] = None, *,
              num_hidden_layers: Optional[int] = None, dtype=torch.float32,
              generator: Optional[torch.Generator] = None, device="cuda",
              init: bool = True) -> Jamba:
    """Build the language model ``name`` (:func:`lm_config`'s
    configuration) on ``device``, its parameters drawn from ``generator``
    (on ``device``) with the published initialisation; with ``init``
    False they are left unset, for a state dict to fill. ``dtype`` is the
    block dtype (parameters stay float32)."""
    dev = resolve_device(device)
    cfg = lm_config(name, config, num_hidden_layers=num_hidden_layers)
    with torch.device("meta"):
        model = Jamba(cfg, dtype=dtype)
    model = model.to_empty(device=dev)
    return model.reset_parameters(generator) if init else model
