"""Checkpoints of the PyTorch port: ``.pth`` files in the reference schema.

Counterpart of ``medmamba_tpu/train/checkpoint.py`` without Orbax. A
training checkpoint is one ``.pth`` holding ``epoch``, ``model_state_dict``,
``optimizer_state_dict``, ``best_acc``, ``num_classes`` and
``class_indices`` (the reference train.py's payload). ``restore_params``
also reads a bare state dict. Files are loaded with ``weights_only=True``:
tensors and plain containers only, no arbitrary unpickling.

A model partitioned over a mesh's model axis (``parallel/mesh.py:
partition_params``) saves the file one process saves: its shards, and
their AdamW moments, are gathered whole first, so every rank of its
model group calls :func:`save_checkpoint` (the gathers are collectives)
and the group's first rank of the first data row writes. A whole file
loads into a partitioned model and optimizer, each rank keeping its
slices.

Crash safety, as the JAX package keeps it: a save writes ``path + ".tmp"``
and replaces ``path`` with it in one rename, so a crash leaves the old file
or the new one, never half of one; the training CLI deletes a superseded
best only after the new best has been renamed into place.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from medmamba_tpu_torch.parallel.mesh import (full_state_dict, model_group,
                                              model_shard, process_slice,
                                              take_shard, unshard)

META_KEYS = ("epoch", "best_acc", "num_classes", "class_indices")


def restore_params(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(state_dict on the CPU, meta) from a ``.pth`` file.

    An Orbax checkpoint directory of the JAX package cannot be read without
    JAX and raises.
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


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, *, epoch: int,
                    best_acc: float, num_classes: int,
                    class_indices: Dict) -> None:
    """Write a training checkpoint to ``path`` atomically (see above). A
    partitioned model's shards are gathered first: every rank of its model
    group calls this, and only the first rank of the first data row
    writes."""
    partitioned = any(model_shard(p) is not None for p in model.parameters())
    payload = {
        "epoch": int(epoch),
        "model_state_dict": {k: v.detach().cpu()
                             for k, v in full_state_dict(model).items()},
        "optimizer_state_dict": portable_optimizer_state(optimizer),
        "best_acc": float(best_acc),
        "num_classes": int(num_classes),
        "class_indices": dict(class_indices),
    }
    if partitioned and (dist.get_rank(model_group()), process_slice()[0]) \
            != (0, 0):
        return
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _params(optimizer: torch.optim.Optimizer) -> list:
    """The optimizer's parameters in the order its state dict numbers
    them."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def delete_checkpoint(path: Optional[str]) -> None:
    """Remove a superseded checkpoint; call it only once the file that
    replaces it is in place."""
    if path and os.path.exists(path):
        os.remove(path)


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> Dict:
    """Load a training checkpoint into ``model`` (strictly) and, when given,
    ``optimizer``; returns the meta (epoch, best_acc, num_classes,
    class_indices)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model_state_dict"], strict=True)
    if optimizer is not None:
        load_optimizer_state(optimizer, payload["optimizer_state_dict"])
    return {k: payload[k] for k in META_KEYS if k in payload}


_LR_KEYS = ("lr", "initial_lr")


def portable_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` as an eager AdamW writes it: a tensor
    learning rate (and the scheduler's ``initial_lr``) as a float,
    ``capturable`` false, each ``step`` a float32 tensor on the CPU. The
    training optimizer of the port (``trainer.make_optimizer``) keeps the
    rate in a tensor and, on the card, its steps there; a file from either
    kind resumes the other (:func:`load_optimizer_state`). A partitioned
    parameter's moments are gathered whole (a collective of the model
    group)."""
    sd = optimizer.state_dict()
    for i, p in enumerate(_params(optimizer)):
        shard = model_shard(p)
        if shard is not None and i in sd["state"]:
            sd["state"][i] = {k: unshard(v, shard) if torch.is_tensor(v)
                              and v.shape == p.shape else v
                              for k, v in sd["state"][i].items()}
    groups = []
    for g in sd["param_groups"]:
        g = dict(g)
        for k in _LR_KEYS:
            if torch.is_tensor(g.get(k)):
                g[k] = float(g[k])
        if "capturable" in g:
            g["capturable"] = False
        groups.append(g)
    state = {i: {k: (v.detach().to("cpu", torch.float32)
                     if k == "step" and torch.is_tensor(v) else v)
                 for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {"state": state, "param_groups": groups}


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: Dict) -> None:
    """Load ``state_dict`` (from either kind of optimizer) into
    ``optimizer`` keeping its own kind: its ``capturable`` flag (which
    places each ``step`` on the parameters' device or the CPU) and its
    learning rate's type: where it is a tensor, that same tensor, filled in
    place with the loaded rate; else a float. The moments and steps are new tensors, so a step
    captured before the load would replay with the old ones: its state
    guard raises (``utils/graphs.py``); load before the first call. A
    partitioned parameter keeps its slice of a whole moment."""
    own = [dict(g) for g in optimizer.param_groups]
    state = dict(state_dict["state"])
    for i, p in enumerate(_params(optimizer)):
        shard = model_shard(p)
        if shard is None or i not in state:
            continue
        dim, _, n = shard
        state[i] = {k: take_shard(v, shard) if torch.is_tensor(v)
                    and v.ndim == p.ndim and v.shape[dim] == n * p.shape[dim]
                    else v for k, v in state[i].items()}
    groups = []
    for g, mine in zip(state_dict["param_groups"], own):
        g = dict(g)
        if "capturable" in mine:
            g["capturable"] = mine["capturable"]
        groups.append(g)
    optimizer.load_state_dict({"state": state, "param_groups": groups})
    for g, mine in zip(optimizer.param_groups, own):
        for k in _LR_KEYS:
            if k not in g:
                continue
            if torch.is_tensor(mine.get(k)):
                mine[k].fill_(float(g[k]))
                g[k] = mine[k]
            elif torch.is_tensor(g[k]):
                g[k] = float(g[k])


def save_class_indices(save_dir: str, class_indices: Dict) -> str:
    """The ``class_indices.json`` sidecar beside the checkpoints."""
    p = os.path.join(save_dir, "class_indices.json")
    with open(p, "w") as f:
        json.dump({str(k): v for k, v in class_indices.items()}, f, indent=4)
    return p
