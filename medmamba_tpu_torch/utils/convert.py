"""Weights between the JAX package's variables and the port's state dict.

Counterpart of ``medmamba_tpu/utils/torch_interop.py`` (its name map is
copied here, so this module needs no JAX). The JAX side is the variables as
nested dicts of numpy arrays, ``{"params": ..., "batch_stats": ...}``; the
port's side is the reference MedMamba ``state_dict`` schema, for the VSSM
and for ``VSSMSeg`` (``models/decoder.py``). ``VSSMSeg``'s encoder keeps the
VSSM's names; its decoder's follow the modules of the reference's
``temp.py`` as the JAX ``decoder.py`` cites them
(``layers_up.{i}.upsample.expand.weight``, ``layers_up.{i}.upsample.norm.*``,
``layers_up.{i}.blocks.{j}.*`` as the encoder's blocks,
``final_up.expand.weight``, ``final_up.norm.*``, and the 1x1 conv
``head.weight``/``head.bias``). ``temp.py`` is not in the repository, so
that part of the schema is the port's. In both directions:

* Linear weights: flax (in, out) <-> torch (out, in);
* conv weights: flax HWIO <-> torch OIHW;
* BatchNorm: flax ``scale``/``bias`` params and ``mean``/``var`` batch stats
  <-> torch ``weight``/``bias``/``running_mean``/``running_var``, plus
  ``num_batches_tracked``, which flax does not keep.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

_BN_IDX = {"0": "conv_bn0", "2": "conv_bn1", "5": "conv_bn2"}
_CONV_IDX = {"1": "conv3x3_0", "4": "conv3x3_1", "7": "conv1x1"}
_LN_PARAM = {"weight": "scale", "bias": "bias"}
_BN_PARAM = {"weight": ("params", "scale"), "bias": ("params", "bias"),
             "running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var")}


def _translate(key: str, ndim: int):
    """(collection, path, transform) for a state-dict key holding an array
    of ``ndim`` dimensions, or None for keys without a flax counterpart
    (num_batches_tracked)."""
    parts = key.split(".")

    if key.startswith("patch_embed.proj."):
        return "params", ("patch_embed", "proj",
                          "kernel" if parts[-1] == "weight" else "bias"), \
            ("conv_oihw" if parts[-1] == "weight" else "none")
    if key.startswith("patch_embed.norm."):
        return "params", ("patch_embed", "norm", _LN_PARAM[parts[-1]]), "none"
    if key.startswith("head."):       # the VSSM's Linear, VSSMSeg's 1x1 conv
        return "params", ("head", "kernel" if parts[-1] == "weight" else "bias"), \
            (_kernel_tag(ndim) if parts[-1] == "weight" else "none")

    m = re.match(r"(?:layers_up\.(\d+)\.upsample|final_up)\.(expand|norm)\."
                 r"(\w+)$", key)
    if m:
        i, mod, p = m.groups()
        base = ("final_up",) if i is None else (f"layers_up_{i}", "upsample")
        if mod == "norm":
            return "params", base + ("norm", _LN_PARAM[p]), "none"
        return "params", base + ("expand", "kernel"), "linear"

    m = re.match(r"layers\.(\d+)\.downsample\.(norm|reduction)\.(\w+)$", key)
    if m:
        i, mod, p = m.groups()
        base = (f"layers_{i}", "downsample")
        if mod == "norm":
            return "params", base + ("norm", _LN_PARAM[p]), "none"
        return "params", base + ("reduction", "kernel"), "linear"

    m = re.match(r"(layers|layers_up)\.(\d+)\.blocks\.(\d+)\.(.+)$", key)
    if m is None:
        raise KeyError(f"unrecognized reference parameter: {key}")
    stage, i, j, rest = m.groups()
    base = (f"{stage}_{i}", f"blocks_{j}")
    rp = rest.split(".")

    if rp[0] == "ln_1":
        return "params", base + ("ln_1", _LN_PARAM[rp[1]]), "none"
    if rp[0] == "self_attention":
        sa = base + ("self_attention",)
        name = rp[1]
        if name in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias",
                    "A_logs", "Ds"):
            return "params", sa + (name,), "none"
        if name in ("in_proj", "out_proj"):
            return "params", sa + (name, "kernel" if rp[2] == "weight"
                                   else "bias"), \
                ("linear" if rp[2] == "weight" else "none")
        if name == "conv2d":
            return "params", sa + ("conv2d",
                                   "kernel" if rp[2] == "weight" else "bias"), \
                ("conv_oihw" if rp[2] == "weight" else "none")
        if name == "out_norm":
            return "params", sa + ("out_norm", _LN_PARAM[rp[2]]), "none"
        raise KeyError(f"unrecognized SS2D parameter: {key}")
    if rp[0] == "conv33conv33conv11":
        idx, p = rp[1], rp[2]
        if p == "num_batches_tracked":
            return None
        if idx in _BN_IDX:
            coll, leaf = _BN_PARAM[p]
            return coll, base + (_BN_IDX[idx], leaf), "none"
        if idx in _CONV_IDX:
            return "params", base + (_CONV_IDX[idx],
                                     "kernel" if p == "weight" else "bias"), \
                ("conv_oihw" if p == "weight" else "none")
    raise KeyError(f"unrecognized reference parameter: {key}")


def _kernel_tag(ndim: int) -> str:
    """A flax kernel's layout: 4-d convolutions (HWIO), 2-d Dense layers."""
    return "conv_oihw" if ndim == 4 else "linear"


def _tag_for(keys: Sequence[str], ndim: int) -> str:
    return _kernel_tag(ndim) if keys[-1] == "kernel" else "none"


def _untranslate(keys: Sequence[str]) -> str:
    """flax path -> state-dict key."""
    conv_rev = {v: k for k, v in _CONV_IDX.items()}
    bn_rev = {v: k for k, v in _BN_IDX.items()}
    leaf_names = {"kernel": "weight", "scale": "weight",
                  "mean": "running_mean", "var": "running_var"}
    parts = []
    for k in keys:
        m = re.match(r"(layers_up|layers|blocks)_(\d+)$", k)
        if m:
            parts += [m.group(1), m.group(2)]
        elif k in conv_rev:
            parts += ["conv33conv33conv11", conv_rev[k]]
        elif k in bn_rev:
            parts += ["conv33conv33conv11", bn_rev[k]]
        else:
            parts.append(leaf_names.get(k, k))
    return ".".join(parts)


def _to_torch_layout(arr: np.ndarray, tag: str) -> np.ndarray:
    if tag == "linear":           # flax (in, out) -> torch (out, in)
        return arr.T
    if tag == "conv_oihw":        # flax (kh, kw, I, O) -> torch (O, I, kh, kw)
        return arr.transpose(3, 2, 0, 1)
    return arr


def _to_flax_layout(arr: np.ndarray, tag: str) -> np.ndarray:
    if tag == "linear":
        return arr.T
    if tag == "conv_oihw":
        return arr.transpose(2, 3, 1, 0)
    return arr


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables (nested dicts of arrays) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for keys, leaf in _leaves(variables.get(coll, {})):
            arr = np.asarray(leaf, np.float32)
            arr = _to_torch_layout(arr, _tag_for(keys, arr.ndim))
            sd[_untranslate(keys)] = torch.from_numpy(np.ascontiguousarray(arr))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return sd


def state_dict_to_jax(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The port's (or the reference's) state dict -> JAX variables as nested
    dicts of float32 numpy arrays."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        tr = _translate(key, arr.ndim)
        if tr is None:
            continue
        coll, path, tag = tr
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(
            _to_flax_layout(arr.astype(np.float32), tag))
    return out
