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
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from medmamba_tpu_torch.data.transforms import preprocess


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   npz_mode: bool,
                   epoch_schedule: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.optim.AdamW,
                              Optional[torch.optim.lr_scheduler.MultiStepLR]]:
    """AdamW as train.py:189-192 and, where ``epoch_schedule`` names
    milestones, the per-epoch MultiStepLR of train.py:194-199 (the caller
    steps it once per epoch); else no scheduler."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01 if npz_mode else 1e-4)
    sched = None
    if epoch_schedule:
        sched = torch.optim.lr_scheduler.MultiStepLR(
            opt, milestones=[int(m) for m in epoch_schedule], gamma=0.1)
    return opt, sched


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows with label >= 0; 0 (not NaN) when no
    row is valid."""
    valid = labels >= 0
    losses = F.cross_entropy(logits.float(), labels.clamp_min(0),
                             reduction="none")
    return (losses * valid).sum() / valid.sum().clamp_min(1)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               images_u8: torch.Tensor, labels: torch.Tensor, *,
               generator: torch.Generator, augment: bool = False,
               image_size: int = 224) -> torch.Tensor:
    """One step on a uint8 NHWC batch and its labels, both on the model's
    device. Returns the loss as a device scalar (no host sync)."""
    model.train()
    x = preprocess(images_u8, size=image_size, augment=augment,
                   generator=generator)
    logits = model(x, labels >= 0, generator=generator)
    loss = cross_entropy(logits, labels)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: torch.nn.Module, images_u8: torch.Tensor,
              labels: torch.Tensor, *, image_size: int = 224
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(number of correct rows among those with label >= 0, logits) of a
    batch, in eval mode; both stay on the device."""
    model.eval()
    logits = model(preprocess(images_u8, size=image_size))
    correct = ((logits.argmax(-1) == labels) & (labels >= 0)).sum()
    return correct, logits
