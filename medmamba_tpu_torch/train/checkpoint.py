"""Inference-side checkpoint loading for the PyTorch port.

Counterpart of ``restore_params`` in ``medmamba_tpu/train/checkpoint.py``. The
port reads ``.pth`` files in the reference payload schema ({model_state_dict,
num_classes, class_indices, epoch, best_acc, ...}) or a bare state dict.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

META_KEYS = ("epoch", "best_acc", "num_classes", "class_indices")


def restore_params(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(state_dict on the CPU, meta) from a ``.pth`` file.

    Loaded with ``weights_only=True``: tensors and plain containers only, no
    arbitrary unpickling. An Orbax checkpoint directory of the JAX package
    cannot be read without JAX and raises.
    """
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint of the JAX package); "
            "the PyTorch port reads .pth files. Make one with "
            "`python -m medmamba_tpu.cli.convert --reverse --checkpoint "
            f"{path} --out weights.pth`")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model_state_dict" in payload:
        meta = {k: payload[k] for k in META_KEYS if k in payload}
        return payload["model_state_dict"], meta
    return payload, {}
