"""Process groups, the device mesh and the data-parallel helpers of the port.

Counterpart of ``medmamba_tpu/parallel/mesh.py``. There, one program sees
the global batch as one array sharded over the ``data`` axis of a
``("data", "model")`` mesh, and GSPMD turns every sum over the batch into a
sum across devices. Here each rank is a process of its own (``torchrun``,
one per card) that holds its contiguous slice of the global batch, and the
sums that cross the batch are made explicit:

* the loss: the rank's sum over its valid rows divided by the valid count
  of the global batch (``train/trainer.py: cross_entropy``);
* the gradients: summed over the data axis through one flat buffer, one
  collective a step (``train/trainer.py: train_step``);
* BatchNorm's masked statistics: summed over the data axis before the mean
  and the variance are formed (``models/vssm.py: MaskedBatchNorm``);
* random draws: made for the global batch from the generator every rank
  seeds alike, each rank keeping its rows (``data/transforms.py:
  random_augment``, ``models/vssm.py: DropPath.sample``).

A plain ``DistributedDataParallel`` step computes none of these as the
JAX package does: it averages per-rank mean losses and normalises with
per-rank statistics.

:func:`make_mesh` builds the process group and the ``DeviceMesh`` and makes
it the active mesh, which the trainer and ``MaskedBatchNorm`` consult
(``data_group``), as the JAX package's kernel wrappers consult its
``_ACTIVE_MESH``. Without a torchrun environment and without arguments it
builds nothing and every path runs as one process. On the card the backend
is NCCL, on the CPU gloo; the collectives below run on either.

Only the data axis is ported: the ``model`` axis (tensor parallelism,
``partition_params``/``_spec_for`` in the JAX module) raises.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# The mesh most recently built by make_mesh, or None (one process)
_ACTIVE_MESH = None


def active_mesh():
    return _ACTIVE_MESH


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              device=None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None,
              backend: Optional[str] = None):
    """The ``("data", "model")`` ``DeviceMesh`` of this process's group,
    made the active mesh; None, and no active mesh, where no group was
    asked for.

    The group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from the arguments
    (``rank``, ``world_size``, ``init_method``, e.g. ``file://...`` or
    ``tcp://localhost:<port>``); a group that is already initialised is
    used as it is. ``device``: "cuda" (the default where a card is
    present) binds the rank to ``cuda:LOCAL_RANK`` (else to ``rank``'s
    card, or to the current card where a group was made before), a
    ``cuda:<i>`` to that
    card (two ranks on one card over gloo), "cpu" to nothing. ``backend``:
    NCCL on the card and gloo on the CPU by default. ``n_model`` > 1 raises
    ``NotImplementedError``: tensor parallelism is not ported."""
    if n_model != 1:
        raise NotImplementedError(
            "tensor parallelism over the 'model' axis (partition_params, "
            "_spec_for and the scan's reshard over ('data', 'model'); "
            "ROADMAP.md §A) is not ported: n_model must be 1")
    asked = (world_size is not None or rank is not None
             or init_method is not None or "WORLD_SIZE" in os.environ)
    if not dist.is_initialized() and not asked:
        set_active_mesh(None)
        return None
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", rank if rank is not None
                else torch.cuda.current_device())))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method, rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size)
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} does not cover "
                         f"the {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device.type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
    set_active_mesh(mesh)
    return mesh


def data_group(mesh=None):
    """The process group of the data axis of ``mesh`` (the active mesh by
    default), or None where there is no mesh."""
    mesh = active_mesh() if mesh is None else mesh
    return None if mesh is None else mesh.get_group("data")


def rank_device(mesh=None) -> torch.device:
    """The device this rank computes on: its card where the mesh is on the
    card, else the CPU."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is not None and mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def destroy_mesh() -> None:
    """Destroy the default process group, if any, and forget the active
    mesh."""
    set_active_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def process_slice(mesh=None):
    """(process_index, process_count) of this rank on the data axis, the
    loader's arguments; (0, 1) without a mesh."""
    group = data_group(mesh)
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    if device.type == "cuda":
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


def shard_batch(mesh, images, labels, device=None):
    """This rank's slice of a global batch on its device.

    ``images``/``labels`` (numpy arrays or CPU tensors) are this process's
    contiguous slice of the global batch, as the loader's
    ``process_index``/``process_count`` cut it (the loader raises where the
    global batch does not divide the processes, the JAX package's check);
    on the card they are copied from pinned memory without a host sync.
    ``device`` defaults to :func:`rank_device`."""
    device = rank_device(mesh) if device is None else torch.device(device)
    return _to_device(images, device), _to_device(labels, device)


@torch.no_grad()
def replicate_state(model: torch.nn.Module,
                    opt: Optional[torch.optim.Optimizer] = None,
                    mesh=None) -> None:
    """Broadcast, in place, the parameters, the buffers and the optimizer's
    state tensors (and tensor learning rates) from rank 0 of the data axis:
    the pure data-parallel layout, every rank holding the same state."""
    group = data_group(mesh)
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    tensors = list(model.parameters()) + list(model.buffers())
    if opt is not None:
        for st in opt.state.values():
            tensors += [v for v in st.values() if torch.is_tensor(v)]
        tensors += [g["lr"] for g in opt.param_groups
                    if torch.is_tensor(g["lr"])]
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group's ranks, whose adjoint is the same sum: each
    rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, (ranks, *x.shape),
    differentiable. Made as one summing all-reduce of the rank's slot in a
    zeroed buffer: exact (adding zeros changes no value), its adjoint is
    the same sum, and it runs on every backend that sums CUDA tensors
    (gloo's gather of CUDA tensors is not in every torch)."""
    rank, shape = dist.get_rank(group), tuple(x.shape)
    buf = torch.cat([x.new_zeros((rank,) + shape), x[None],
                     x.new_zeros((dist.get_world_size(group) - rank - 1,)
                                 + shape)])
    return all_reduce_sum(buf, group)
