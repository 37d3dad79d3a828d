"""Deployment export: the eval forward as a serialized ``torch.export``
artifact.

Counterpart of ``medmamba_tpu/utils/export.py``. ``export_forward`` traces
``softmax(model(preprocess(images)))`` into an ``ExportedProgram`` and
serializes it: raw uint8 (b, input_size, input_size, 3) frames in, class
probabilities out, the weights and the preprocessing's resize weights
inside the artifact, the batch symbolic unless pinned. ``load_exported``
reads it back without the model code or a checkpoint.

How it differs from the JAX package's StableHLO artifact:

- Each selective scan is one node of the graph, an op of
  ``ops/scan_op.py``: K1 on the card, or K3 when the artifact was exported
  under ``MEDMAMBA_SCAN_KERNEL=hillis`` (read while tracing, never when the
  artifact runs); the plain scan on the CPU. So loading needs
  ``medmamba_tpu_torch`` importable, for the ops and for K1/K3's build from
  its ``csrc/``; it needs no checkpoint: the weights are in the artifact.
- There is no ``platforms`` argument: the artifact's tensors live on the
  device it was exported on (``device``), and it runs there.
"""
from __future__ import annotations

import copy
import io
from typing import Optional

import torch

from medmamba_tpu_torch.data.transforms import preprocess
from medmamba_tpu_torch.ops import scan_op  # noqa: F401  (registers the ops)
from medmamba_tpu_torch.utils.device import resolve_device

# the batch a symbolic-batch artifact is traced at: torch specialises a
# dimension of size 0 or 1 to a constant
TRACE_BATCH = 2


class _Forward(torch.nn.Module):
    def __init__(self, model: torch.nn.Module, image_size: int,
                 with_preprocess: bool):
        super().__init__()
        self.model = model
        self.image_size = image_size
        self.with_preprocess = with_preprocess

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.with_preprocess:
            x = preprocess(images, size=self.image_size)
        else:
            x = images.float()
        return torch.softmax(self.model(x), dim=-1)


def export_forward(model: torch.nn.Module, *, image_size: int = 224,
                   batch: Optional[int] = None,
                   input_size: Optional[int] = None,
                   with_preprocess: bool = True,
                   device="cuda") -> bytes:
    """Serialize the eval forward (uint8 images -> class probabilities).

    batch=None exports a symbolic batch dimension (any batch from 1 at call
    time); an int pins it. ``with_preprocess`` fuses the training recipe's
    preprocessing (resize to ``image_size`` and the 0.5/0.5 normalisation),
    so the artifact takes raw uint8 (B, input_size, input_size, 3) frames;
    ``input_size`` is the fixed spatial size it accepts (default
    ``image_size``); without it the artifact takes float32 input at
    ``image_size``. The model is copied onto ``device`` (``cuda`` by
    default; raises without a card unless ``cpu``) in eval mode with its
    parameters frozen, and traced without gradients, so every scan is a
    graph op (a differentiable scan would call a kernel FakeTensors cannot
    run).
    """
    dev = resolve_device(device)
    in_size = input_size or image_size
    if not with_preprocess and in_size != image_size:
        raise ValueError("input_size != image_size requires the baked-in "
                         "preprocess (it performs the resize)")
    net = copy.deepcopy(model).to(dev).eval().requires_grad_(False)
    example = torch.zeros(
        (TRACE_BATCH if batch is None else batch, in_size, in_size, 3),
        dtype=torch.uint8 if with_preprocess else torch.float32, device=dev)
    dynamic = None if batch is not None else (
        {0: torch.export.Dim("batch", min=1)},)
    with torch.no_grad():
        program = torch.export.export(
            _Forward(net, image_size, with_preprocess), (example,),
            dynamic_shapes=dynamic, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class Exported:
    """A loaded artifact: ``call(images)`` runs it without gradients on
    images on the device it was exported on, at the port's precision there
    (on the card float32 without TF32, which ``resolve_device`` fixes for
    the process: the flags are not part of the graph)."""

    def __init__(self, program: torch.export.ExportedProgram):
        resolve_device(next(iter(program.state_dict.values())).device)
        self.program = program
        self._module = program.module()

    def call(self, images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._module(images)


def load_exported(blob: bytes) -> Exported:
    """Deserialize an artifact of :func:`export_forward`."""
    return Exported(torch.export.load(io.BytesIO(blob)))
