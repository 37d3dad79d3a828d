"""Training core of the PyTorch port: optimizer factory, loss, train/eval steps.

Counterpart of ``medmamba_tpu/train/trainer.py``, with the reference trainer's
choices (train.py:187-199):

* cross-entropy, here masked: label -1 marks the rows the loader padded onto
  a final partial batch; they count neither in the loss nor in the BatchNorm
  statistics;
* AdamW with betas (0.9, 0.999) and eps 1e-8; weight decay 0.01 in NPZ mode
  (torch's default, which the reference leaves) and 1e-4 in folder mode, on
  every parameter;
* MultiStepLR at the given epochs, x0.1, stepped once per epoch, NPZ mode
  only.

One step: on-device preprocessing (flip + rotation when augmenting, resize,
normalisation) -> forward in train mode -> loss -> backward -> AdamW. The
random draws (augmentation, DropPath) come from the caller's generator.

Data parallelism (``parallel/mesh.py``): under an active mesh each rank
steps on its contiguous slice of the global batch and the step computes
what one process computes on the whole batch, as the JAX package's step
does on a mesh: draws for the global batch, each rank keeping its rows;
BatchNorm statistics over the global batch (``MaskedBatchNorm``); the loss
as the rank's sum over its valid rows divided by the global valid count;
the gradients and that loss summed over the data axis in one flat
all-reduce before AdamW, so every rank applies the same update and
returns the global loss. ``eval_step``'s count is summed over ranks. A
``DistributedDataParallel`` step would average per-rank means and
normalise with per-rank statistics, which differ from this whenever ranks
hold different numbers of valid rows, and at every step in BatchNorm.
Without a mesh no collective runs.

Tensor parallelism (the mesh's ``model`` axis, ``parallel/mesh.py``): the
ranks of one data row step on the same rows, hold their shards of the
partitioned parameters and compute the same loss. Every sum above stays
on the data group, whose ranks hold the same shards, so a shard's
summed gradient is this rank's part of the global one. A replicated
parameter's gradient (and the loss) is then broadcast from the model
group's first rank, so the model ranks apply the same update to the same
bits whatever their kernels' rounding.

``train_step``, ``eval_step`` and ``predict`` (the served softmax forward)
are the eager steps: the library API on any device, and the reference the
graphs are held against. ``compile_train_step``, ``compile_eval_step`` and
``compile_forward`` capture them as CUDA graphs, one per static signature
(``utils/graphs.py``), the counterpart of the JAX package's ``jax.jit``
steps; the CLIs run those on the card. The optimizer is built for that:
its learning rate is a tensor on the parameters' device, which
``MultiStepLR`` fills in place, and on the card it is ``capturable`` (its
step counters live on the card), so a captured step reads each epoch's
rate and makes no host sync. Under a mesh the graphs hold the steps'
NCCL collectives; a gloo group's cannot be captured, so under one the
eager steps run.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from medmamba_tpu_torch.data.transforms import preprocess, preprocess_imagenet
from medmamba_tpu_torch.parallel.mesh import (data_group, model_group,
                                              model_shard)
from medmamba_tpu_torch.utils import graphs


# the devices whose AdamW is ``capturable`` (its step counters on the
# device, no host sync): where torch captures CUDA graphs
CAPTURABLE_DEVICES = ("cuda",)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   npz_mode: bool,
                   epoch_schedule: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.optim.AdamW,
                              Optional[torch.optim.lr_scheduler.MultiStepLR]]:
    """AdamW as train.py:189-192 and, where ``epoch_schedule`` names
    milestones, the per-epoch MultiStepLR of train.py:194-199 (the caller
    steps it once per epoch); else no scheduler. The learning rate is a
    float32 tensor on the parameters' device, and the optimizer is
    ``capturable`` on CAPTURABLE_DEVICES."""
    params = list(params)
    device = params[0].device
    opt = torch.optim.AdamW(params, lr=torch.tensor(float(lr), device=device),
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01 if npz_mode else 1e-4,
                            capturable=device.type in CAPTURABLE_DEVICES)
    sched = None
    if epoch_schedule:
        sched = torch.optim.lr_scheduler.MultiStepLR(
            opt, milestones=[int(m) for m in epoch_schedule], gamma=0.1)
    return opt, sched


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  group=None) -> torch.Tensor:
    """Mean cross-entropy over the rows with label >= 0; 0 (not NaN) when no
    row is valid. With a data-axis ``group``, this rank's sum over its valid
    rows divided by the valid count of the global batch (one all-reduce of
    the count, no host sync): the ranks' losses sum to the global mean."""
    valid = labels >= 0
    losses = F.cross_entropy(logits.float(), labels.clamp_min(0),
                             reduction="none")
    count = valid.sum()
    if group is not None:
        count = count.float()
        dist.all_reduce(count, group=group)
    return (losses * valid).sum() / count.clamp_min(1)


def rank_rows(batch: int, group) -> Optional[Tuple[int, int]]:
    """(first row, rows) of this rank's slice of the global batch, the
    ``rows`` argument of the draws; None without a group."""
    if group is None:
        return None
    return (dist.get_rank(group) * batch,
            dist.get_world_size(group) * batch)


def sum_grads(params: Sequence[torch.nn.Parameter], loss: torch.Tensor,
              group) -> torch.Tensor:
    """Sum the gradients of the parameters that have one, and ``loss``, over
    ``group`` through one flat buffer (one collective, not one a
    parameter); those gradients become views of the summed buffer, and a
    parameter without a gradient keeps none, so AdamW leaves it alone as it
    does in one process. Every rank runs the same graph, so every rank
    flattens the same parameters. Where the active mesh's model group has
    more than one rank, the loss and the replicated parameters' gradients,
    which lead the buffer, are then broadcast from its first rank (one
    more collective). Returns the summed loss."""
    params = [p for p in params if p.grad is not None]
    params.sort(key=lambda p: model_shard(p) is not None)
    flat = torch.cat([loss.reshape(1)] + [p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    model_axis = model_group()
    if model_axis is not None and dist.get_world_size(model_axis) > 1:
        whole = 1 + sum(p.numel() for p in params if model_shard(p) is None)
        dist.broadcast(flat[:whole], src=dist.get_global_rank(model_axis, 0),
                       group=model_axis)
    for p, g in zip(params, flat[1:].split([p.numel() for p in params])):
        p.grad = g.view_as(p)
    return flat[0]


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               images_u8: torch.Tensor, labels: torch.Tensor, *,
               generator: torch.Generator, augment: bool = False,
               image_size: int = 224) -> torch.Tensor:
    """One step on a uint8 NHWC batch and its labels, both on the model's
    device (under a mesh: this rank's slice of the global batch). Returns
    the (global batch's) loss as a device scalar (no host sync)."""
    model.train()
    group = data_group()
    rows = rank_rows(images_u8.shape[0], group)
    x = preprocess(images_u8, size=image_size, augment=augment,
                   generator=generator, rows=rows)
    logits = model(x, labels >= 0, generator=generator, rows=rows)
    loss = cross_entropy(logits, labels, group)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        loss = sum_grads([p for g in opt.param_groups for p in g["params"]],
                         loss, group)
    opt.step()
    return loss


@torch.no_grad()
def eval_step(model: torch.nn.Module, images_u8: torch.Tensor,
              labels: torch.Tensor, *, image_size: int = 224
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(number of correct rows among those with label >= 0, logits) of a
    batch, in eval mode; both stay on the device. Under a mesh the count is
    summed over the data axis (the logits stay this rank's)."""
    model.eval()
    logits = model(preprocess(images_u8, size=image_size))
    correct = ((logits.argmax(-1) == labels) & (labels >= 0)).sum()
    group = data_group()
    if group is not None:
        dist.all_reduce(correct, group=group)
    return correct, logits


@torch.no_grad()
def predict(model: torch.nn.Module, images_u8: torch.Tensor, *,
            image_size: int = 224, imagenet_preproc: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax probabilities, the preprocessed batch) of a uint8 NHWC batch
    on the model's device, in eval mode: the served forward. With
    ``imagenet_preproc`` the batch is preprocessed as the reference
    ConfusionMatrix script does (``preprocess_imagenet``)."""
    model.eval()
    prep = preprocess_imagenet if imagenet_preproc else preprocess
    x = prep(images_u8, size=image_size)
    return torch.softmax(model(x), dim=-1), x


def _snapshot(model: torch.nn.Module,
              opt: Optional[torch.optim.Optimizer] = None,
              generators: Sequence[torch.Generator] = ()
              ) -> Callable[[], None]:
    """A ``restore()`` that puts back, in place, the model's parameters and
    buffers (BatchNorm statistics and ``num_batches_tracked`` among them),
    the optimizer's state and the generators' states as they are now. An
    optimizer state made after the snapshot is zeroed: AdamW's fresh state
    (step 0, zero moments)."""
    tensors = list(model.parameters()) + list(model.buffers())
    saved = [t.detach().clone() for t in tensors]
    opt_saved = {} if opt is None else {
        p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
        for p, st in opt.state.items()}
    gen_saved = [g.get_state() for g in generators]

    @torch.no_grad()
    def restore():
        for t, s in zip(tensors, saved):
            t.copy_(s)
        for p, st in ({} if opt is None else opt.state).items():
            old = opt_saved.get(p)
            for k, v in st.items():
                if torch.is_tensor(v):
                    v.copy_(old[k]) if old is not None else v.zero_()
        for g, s in zip(generators, gen_saved):
            g.set_state(s)
    return restore


def compile_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, *,
                       generator: torch.Generator) -> graphs.CompiledStep:
    """:func:`train_step` as CUDA graphs: call the result as
    ``step(images_u8, labels, augment=..., image_size=...)`` (inputs on the
    host or the card) for the loss, a device scalar that the next call
    overwrites. The whole step is one graph: preprocessing with K5, the
    forward, the loss, the backward (``train_step`` sets the gradients to
    None before it, so they live in the graph's pool) and AdamW. Draws
    come from ``generator``, registered with each graph; the warm-up's
    effects on the model, the optimizer and the generator are undone, so
    the first replay is the first training step."""
    def capture(images, labels, *, augment=False, image_size=224):
        restore = _snapshot(model, opt, [generator])

        def step(im, lb):
            return train_step(model, opt, im, lb, generator=generator,
                              augment=augment, image_size=image_size)
        return graphs.Graph(step, (images, labels), label="train step",
                            model=model, opt=opt, restore=restore,
                            generators=[generator])
    return graphs.CompiledStep(
        "train_step", capture,
        free=lambda: opt.zero_grad(set_to_none=True))


def compile_eval_step(model: torch.nn.Module) -> graphs.CompiledStep:
    """:func:`eval_step` as CUDA graphs: ``step(images_u8, labels,
    image_size=...)`` gives (correct, logits) on the card, overwritten by
    the next call."""
    def capture(images, labels, *, image_size=224):
        def step(im, lb):
            return eval_step(model, im, lb, image_size=image_size)
        return graphs.Graph(step, (images, labels), label="eval step",
                            model=model)
    return graphs.CompiledStep("eval_step", capture)


def compile_forward(model: torch.nn.Module) -> graphs.CompiledStep:
    """:func:`predict` as CUDA graphs: ``forward(images_u8, image_size=...,
    imagenet_preproc=...)`` gives (probabilities, preprocessed batch) on
    the card, overwritten by the next call."""
    def capture(images, *, image_size=224, imagenet_preproc=False):
        def forward(im):
            return predict(model, im, image_size=image_size,
                           imagenet_preproc=imagenet_preproc)
        return graphs.Graph(forward, (images,), label="forward", model=model)
    return graphs.CompiledStep("forward", capture)


def forward_fn(model: torch.nn.Module, device: torch.device, **static
               ) -> Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """The served forward of the CLIs on ``device``: on the card
    :func:`compile_forward` (one graph per batch shape; its outputs are
    overwritten by the next call), on the CPU :func:`predict`. Called on a
    uint8 NHWC batch on the host or the device, with the static arguments
    of ``predict`` given here."""
    if device.type == "cuda":
        forward = compile_forward(model)
        return lambda images: forward(images, **static)
    return lambda images: predict(model, images.to(device), **static)
