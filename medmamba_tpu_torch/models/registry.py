"""Model size registry: T / S / B / Te (counterpart of
``medmamba_tpu/models/registry.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

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
