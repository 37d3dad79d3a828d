"""Weights of the CAM backbones between the JAX package and the port.

``vit_*``, ``swin_*`` and ``mobilenet_*`` ``state_dict_from_jax`` turn the
JAX modules' variables (nested dicts of numpy arrays: ``params``, and
``batch_stats`` for MobileNetV2) into the port's state dict in the
reference schema; each ``state_dict_to_jax`` is its inverse, and a round
trip is exact. They invert the reference-to-flax maps of
``tests/test_backbone_parity.py``:

* Dense kernels (in, out) <-> Linear weights (out, in); conv kernels HWIO
  <-> OIHW (``utils/convert.py``'s layouts, told apart by their rank);
* LayerNorm and BatchNorm ``scale`` <-> ``weight``; BatchNorm ``mean`` /
  ``var`` batch stats <-> ``running_mean`` / ``running_var``, plus a
  ``num_batches_tracked`` of 0, which flax does not keep;
* module names: ViT ``blocks_{i}`` <-> ``blocks.{i}``, ``pre_logits`` <->
  ``pre_logits.fc``; Swin ``patch_embed`` / ``patch_norm`` <->
  ``patch_embed.proj`` / ``patch_embed.norm``, ``layers_{i}_blocks_{j}``
  <-> ``layers.{i}.blocks.{j}``, ``layers_{i}_downsample`` <->
  ``layers.{i}.downsample``; MobileNetV2 ``stem`` / ``block_{i}`` /
  ``head_conv`` <-> ``features.{0 / i + 1 / 18}`` (a block's ``expand``,
  ``dw``, ``project``, ``project_bn`` are the entries of its ``conv``
  sequence), ``classifier`` <-> ``classifier.1``.

A reference Swin state dict's ``relative_position_index`` buffers have no
JAX counterpart (the JAX module recomputes the index) and are skipped.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from medmamba_tpu_torch.models.mobilenet import CFG
from medmamba_tpu_torch.utils.convert import (_leaves, _tag_for,
                                              _to_flax_layout,
                                              _to_torch_layout)

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}
_SKIP = ("num_batches_tracked", "relative_position_index")


def _rename(name: str, rules: Sequence[Tuple[str, str]]) -> str:
    """``name`` through the first rule whose pattern matches all of it;
    unchanged where none does."""
    for pattern, repl in rules:
        m = re.fullmatch(pattern, name)
        if m:
            return m.expand(repl)
    return name


def _from_jax(variables: Dict[str, Any], module: Callable[[str], str]
              ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for keys, leaf in _leaves(variables.get(coll, {})):
            arr = np.asarray(leaf, np.float32)
            arr = _to_torch_layout(arr, _tag_for(keys, arr.ndim))
            name = _LEAF.get(keys[-1], keys[-1])
            if len(keys) > 1:
                name = module(".".join(keys[:-1])) + "." + name
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return sd


def _to_jax(state_dict: Dict[str, Any], module: Callable[[str], str]
            ) -> Dict[str, Any]:
    out: Dict[str, Any] = {"params": {}}
    for key, val in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in _SKIP:
            continue
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        coll = "params"
        if leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            leaf = "kernel" if arr.ndim > 1 else "scale"
        path = (module(prefix).split(".") if prefix else []) + [leaf]
        node = out.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_to_flax_layout(
            arr.astype(np.float32), _tag_for(path, arr.ndim)))
    return out


_VIT_TO_TORCH = ((r"blocks_(\d+)(\..*)?", r"blocks.\1\2"),
                 (r"pre_logits", "pre_logits.fc"))
_VIT_TO_JAX = ((r"blocks\.(\d+)(\..*)?", r"blocks_\1\2"),
               (r"pre_logits\.fc", "pre_logits"))
_SWIN_TO_TORCH = (("patch_embed", "patch_embed.proj"),
                  ("patch_norm", "patch_embed.norm"),
                  (r"layers_(\d+)_blocks_(\d+)(\..*)?", r"layers.\1.blocks.\2\3"),
                  (r"layers_(\d+)_downsample(\..*)?", r"layers.\1.downsample\2"))
_SWIN_TO_JAX = ((r"patch_embed\.proj", "patch_embed"),
                (r"patch_embed\.norm", "patch_norm"),
                (r"layers\.(\d+)\.blocks\.(\d+)(\..*)?", r"layers_\1_blocks_\2\3"),
                (r"layers\.(\d+)\.downsample(\..*)?", r"layers_\1_downsample\2"))

# MobileNetV2: which blocks open with an expansion ConvBNReLU (t != 1), and
# the index of the head ConvBNReLU in ``features``
_EXPANDS = [t != 1 for t, _, n, _ in CFG for _ in range(n)]
_HEAD = len(_EXPANDS) + 1
_BLOCK_PARTS = ("dw", "project", "project_bn")
_CBR = {"conv": "0", "bn": "1"}
_CBR_JAX = {v: k for k, v in _CBR.items()}


def _mnv2_to_torch(name: str) -> str:
    m = re.fullmatch(r"(stem|head_conv)\.(conv|bn)", name)
    if m:
        return f"features.{0 if m[1] == 'stem' else _HEAD}.{_CBR[m[2]]}"
    if name == "classifier":
        return "classifier.1"
    m = re.fullmatch(r"block_(\d+)\.(expand|dw|project|project_bn)"
                     r"(?:\.(conv|bn))?", name)
    if m is None:
        raise KeyError(f"unrecognized MobileNetV2 module: {name}")
    i = int(m[1])
    k = 0 if m[2] == "expand" else _EXPANDS[i] + _BLOCK_PARTS.index(m[2])
    return f"features.{i + 1}.conv.{k}" + ("" if m[3] is None
                                           else "." + _CBR[m[3]])


def _mnv2_to_jax(name: str) -> str:
    m = re.fullmatch(r"features\.(\d+)\.([01])", name)
    if m and int(m[1]) in (0, _HEAD):
        return ("stem" if m[1] == "0" else "head_conv") + "." + _CBR_JAX[m[2]]
    if name == "classifier.1":
        return "classifier"
    m = re.fullmatch(r"features\.(\d+)\.conv\.(\d+)(?:\.([01]))?", name)
    if m is None:
        raise KeyError(f"unrecognized MobileNetV2 module: {name}")
    i, k = int(m[1]) - 1, int(m[2])
    part = "expand" if k < _EXPANDS[i] else _BLOCK_PARTS[k - _EXPANDS[i]]
    return f"block_{i}.{part}" + ("" if m[3] is None
                                  else "." + _CBR_JAX[m[3]])


def vit_state_dict_from_jax(variables: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    return _from_jax(variables, lambda n: _rename(n, _VIT_TO_TORCH))


def vit_state_dict_to_jax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    return _to_jax(state_dict, lambda n: _rename(n, _VIT_TO_JAX))


def swin_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    return _from_jax(variables, lambda n: _rename(n, _SWIN_TO_TORCH))


def swin_state_dict_to_jax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    return _to_jax(state_dict, lambda n: _rename(n, _SWIN_TO_JAX))


def mobilenet_state_dict_from_jax(variables: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    return _from_jax(variables, _mnv2_to_torch)


def mobilenet_state_dict_to_jax(state_dict: Dict[str, Any]
                                ) -> Dict[str, Any]:
    return _to_jax(state_dict, _mnv2_to_jax)
