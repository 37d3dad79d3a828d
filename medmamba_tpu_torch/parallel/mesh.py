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

The ``model`` axis is tensor parallelism (TP), the counterpart of the JAX
module's ``partition_params``/``_spec_for`` and of the scan's batch
reshard over ("data", "model"). The ranks of one data row (one model
group) hold the same rows of the batch and compute the same replicated
activations, and:

* :func:`partition_params` keeps each parameter that ``_spec_for`` shards
  as this rank's slice on the matching dim of the port's layout
  (:func:`shard_dims`); AdamW's moments, made from the parameters, follow;
* a sharded ``nn.Linear`` is column-parallel (``models/vssm.py:
  _linear``): its input enters through :func:`copy_to_model` (identity;
  the adjoint sums the ranks' partial input gradients), this rank's output
  features leave through :func:`from_shards` (an all-gather whose adjoint
  takes this rank's slice back); the SS2D stacks are gathered with
  :func:`from_shards` before use;
* the selective scan (``ops/selective_scan.py``) takes its rows with
  :func:`to_shards` (the adjoint all-gathers) and gives y back with
  :func:`from_shards`, so each model rank runs the kernels on its rows.

Every model rank computes the whole loss downstream of a gather, so the
adjoint of a gather takes a slice, never sums: a summing adjoint
(:func:`all_gather`'s, right where each rank holds a different part of
the loss) would multiply every gradient upstream of it by the model
axis's size. The data axis's sums run over the data group only, whose
ranks hold the same shards.
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
    NCCL on the card and gloo on the CPU by default.

    The mesh is ``n_data x n_model``, row-major as the JAX module reshapes
    its devices: rank ``d * n_model + m`` is data row ``d``, model rank
    ``m``. ``n_data`` defaults to the world over ``n_model``; a mesh that
    does not cover the ranks raises ``ValueError``. Under ``n_model`` > 1
    both axes' groups run one collective here, so a group that cannot form
    (an NCCL communicator that fails to initialise) raises now, not at the
    first step."""
    if n_model < 1:
        raise ValueError(f"n_model must be at least 1, got {n_model}")
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
    if n_model > 1:
        probe = torch.zeros(1, device=device)
        for axis in ("data", "model"):
            dist.all_reduce(probe, group=mesh.get_group(axis))
    set_active_mesh(mesh)
    return mesh


def data_group(mesh=None):
    """The process group of the data axis of ``mesh`` (the active mesh by
    default), or None where there is no mesh."""
    mesh = active_mesh() if mesh is None else mesh
    return None if mesh is None else mesh.get_group("data")


def model_group(mesh=None):
    """The process group of the model axis of ``mesh`` (the active mesh by
    default): the ranks of this rank's data row. None where there is no
    mesh."""
    mesh = active_mesh() if mesh is None else mesh
    return None if mesh is None else mesh.get_group("model")


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


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, (ranks, *x.shape), not
    differentiable: ``all_gather_into_tensor`` on NCCL; elsewhere the rank's
    slot in a zeroed buffer summed over the group (exact; gloo's gather of
    CUDA tensors is not in every torch), in float32 for a narrower float
    so that gloo need not sum it."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((n,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    wide = x.float() if x.is_floating_point() and x.element_size() < 4 \
        else x
    buf = wide.new_zeros((n,) + tuple(x.shape))
    buf[dist.get_rank(group)] = wide
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _AllGather(torch.autograd.Function):
    """Forward: every rank's ``x`` stacked (:func:`_gather`). Backward: the
    stacked gradient summed over the group, this rank's slot of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, (ranks, *x.shape),
    differentiable.

    Its adjoint sums: each rank's slot receives the gradient that every
    rank's loss sends it. That is right where each rank holds a different
    part of the loss (the sequence-parallel scan, whose ranks hold
    different positions). It is wrong under the model axis, where every
    rank computes the same whole loss downstream of the gather: the sum
    would multiply the gradient by the group's size there, so those
    gathers use :func:`from_shards`."""
    return _AllGather.apply(x, group)


# ---------------------------------------------------------------------------
# The model axis: gathers and slices whose adjoints are each other's
# ---------------------------------------------------------------------------


def _join(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' shards (ranks, *shard) joined along ``dim`` of a shard."""
    if dim == 0:
        return stacked.flatten(0, 1)
    return torch.cat(stacked.unbind(0), dim=dim)


def _slice(x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous slice of ``x`` along ``dim``, of ``n``."""
    k = x.shape[dim] // n
    return x.narrow(dim, rank * k, k).contiguous()


class _FromShards(torch.autograd.Function):
    """Forward: the ranks' shards joined along ``dim``. Backward: this
    rank's slice of the gradient (every rank holds the whole gradient of
    the joined tensor)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.n = dist.get_world_size(group)
        ctx.set_materialize_grads(False)
        return _join(_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        return _slice(g, ctx.dim, ctx.rank, ctx.n), None, None


class _ToShards(torch.autograd.Function):
    """Forward: this rank's slice along ``dim``. Backward: the ranks'
    gradients of their slices joined (each rank's slice reaches the loss
    through its rank alone)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.set_materialize_grads(False)
        return _slice(x, dim, dist.get_rank(group), dist.get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        return _join(_gather(g, ctx.group), ctx.dim), None, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the sum over the group, for a
    replicated value that each rank uses on its part of the work (a
    column-parallel layer's input, the scan's parameters under its row
    split)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def from_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The model group's shards of a tensor joined along ``dim``,
    differentiable; its adjoint takes this rank's slice."""
    return _FromShards.apply(x, group, dim % x.ndim)


def to_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor every rank of ``group``
    holds whole, differentiable; its adjoint all-gathers."""
    return _ToShards.apply(x, group, dim % x.ndim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its adjoint sums the gradient over ``group``."""
    return _CopyToModel.apply(x, group)


# ---------------------------------------------------------------------------
# Partition rules (the JAX module's _spec_for / partition_params)
# ---------------------------------------------------------------------------

# the SS2D stacks _spec_for shards, by parameter name, and the dim of the
# port's layout (the JAX layouts' own: (k, r+2n, d_inner), (k, d_inner, r),
# (k*d_inner, n), (k*d_inner,))
SS2D_SHARD_DIMS = {"x_proj_weight": 2, "dt_projs_weight": 1, "A_logs": 0,
                   "Ds": 0}


def shard_dims(model: torch.nn.Module, n_model: int) -> dict:
    """``{parameter name: the dim sharded over n_model ranks, or None}``:
    the JAX ``_spec_for`` carried to the port's layouts. An ``nn.Linear``
    weight (out, in), a flax Dense kernel (in, out) there, is sharded on
    its output features, dim 0; the SS2D stacks on the dims of
    ``SS2D_SHARD_DIMS``; convolution kernels (``_spec_for`` replicates
    them), biases and norms are replicated. A dim that ``n_model`` does not
    divide is replicated, as ``partition_params``' fallback does there."""
    out = {}
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, torch.nn.Linear) and name == "weight":
                dim = 0
            else:
                dim = SS2D_SHARD_DIMS.get(name)
            if dim is not None and p.shape[dim] % n_model:
                dim = None
            out[f"{mod_name}.{name}" if mod_name else name] = dim
    return out


def model_shard(p: torch.Tensor):
    """(dim, rank, ranks) of a partitioned parameter's shard, or None."""
    return getattr(p, "model_shard", None)


def shard_group(shard):
    """The active mesh's model group, checked against a parameter's
    ``shard``: a partitioned model computes only under the mesh it was
    partitioned on."""
    group = model_group()
    if group is None or (dist.get_rank(group), dist.get_world_size(group)) \
            != tuple(shard[1:]):
        raise RuntimeError(
            "a parameter partitioned over the model axis (shard "
            f"{shard[1]} of {shard[2]}) is used outside the mesh it was "
            "partitioned on")
    return group


def partition_params(model: torch.nn.Module, mesh=None) -> torch.nn.Module:
    """Keep, in place, this rank's slice of each parameter that
    :func:`shard_dims` shards over the model axis of ``mesh`` (the active
    mesh by default); a no-op without a mesh or with one model rank.
    Partition before making the optimizer, whose state then follows the
    shards. Each shard is tagged with ``model_shard`` = (dim, rank,
    ranks). A full state dict still loads (``load_state_dict`` keeps this
    rank's slice of each sharded entry); :func:`full_state_dict` gathers
    one. Only models whose layers go through the model axis's seams
    (``TENSOR_PARALLEL``, the VSSM's ``_linear`` and SS2D) can be
    partitioned: another raises ``NotImplementedError``."""
    group = model_group(mesh)
    if group is None or dist.get_world_size(group) == 1:
        return model
    if not getattr(model, "TENSOR_PARALLEL", False):
        raise NotImplementedError(
            f"{type(model).__name__} has no tensor-parallel layers; the "
            "model axis is ported for the VSSM")
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in shard_dims(model, n).items():
            p = params[name]
            if dim is None or model_shard(p) is not None:
                continue
            p.data = _slice(p.data, dim, rank, n)
            p.model_shard = (dim, rank, n)
    sharded = {name: p for name, p in params.items()
               if model_shard(p) is not None}

    def keep_slices(module, state_dict, prefix, *_):
        for name, p in sharded.items():
            t = state_dict.get(prefix + name)
            dim, _, ranks = p.model_shard
            if t is not None and t.shape[dim] == ranks * p.shape[dim]:
                state_dict[prefix + name] = take_shard(t, p.model_shard)
    model.register_load_state_dict_pre_hook(keep_slices)
    return model


def take_shard(t: torch.Tensor, shard) -> torch.Tensor:
    """This rank's slice of a whole tensor, by a parameter's ``shard``."""
    return _slice(t, *shard)


def unshard(t: torch.Tensor, shard) -> torch.Tensor:
    """A tensor of a shard's shape (the shard, its gradient, its AdamW
    moment) joined whole over the active mesh's model group; a collective
    of that group."""
    return _join(_gather(t.detach(), shard_group(shard)), shard[0])


def full_state_dict(model: torch.nn.Module) -> dict:
    """``model.state_dict()`` with each sharded entry gathered whole: the
    state dict one process holds. On a partitioned model, a collective of
    the model group."""
    shards = {name: model_shard(p) for name, p in model.named_parameters()
              if model_shard(p) is not None}
    return {k: unshard(v, shards[k]) if k in shards else v
            for k, v in model.state_dict().items()}
