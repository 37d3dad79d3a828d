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
  artifact runs); the plain scan on the CPU. The same holds for the scan's
  compute mode: each node carries the mode ``MEDMAMBA_SCAN_COMPUTE`` gave
  while tracing (the bfloat16 mode on the card; float32 for the CPU, whose
  scans compute in float32), as a JAX export bakes in the traced kernel;
  ``Exported.scan_compute`` lists them. So loading needs
  ``medmamba_tpu_torch`` importable, for the ops and for K1/K3's build from
  its ``csrc/``; it needs no checkpoint: the weights are in the artifact.
- There is no ``platforms`` argument: the artifact's tensors live on the
  device it was exported on (``device``), and it runs there.
- On the card ``Exported.call`` replays a CUDA graph of the loaded module,
  one per input shape (at most ``EXPORT_GRAPHS``, the least recently used
  freed first; ``utils/graphs.py``), as the JAX package's artifact holds
  ``jax.jit(fwd)``; the scan nodes' launch counts taken at capture are
  added at each replay. On the CPU it runs the module op by op.
"""
from __future__ import annotations

import copy
import io
from typing import Optional

import torch

from medmamba_tpu_torch.data.transforms import preprocess
from medmamba_tpu_torch.ops import scan_op  # noqa: F401  (registers the ops)
from medmamba_tpu_torch.utils import graphs, tracing
from medmamba_tpu_torch.utils.device import resolve_device

# the batch a symbolic-batch artifact is traced at: torch specialises a
# dimension of size 0 or 1 to a constant
TRACE_BATCH = 2
# the graphs an artifact keeps on the card: one per input shape
EXPORT_GRAPHS = 16


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


def compile_module(module: torch.nn.Module) -> graphs.CompiledStep:
    """``module``'s forward without gradients as CUDA graphs, one per
    input shape and dtype, at most EXPORT_GRAPHS of them, the least
    recently used freed first: ``step(images)`` gives the graph's output
    buffer, which the next call overwrites. The module's input checks
    (the pre-hook ``ExportedProgram.module()`` adds) run at capture; its
    parameters, buffers and lifted constants are watched by the graphs'
    state guard. Raises for a module off the card: nothing falls back to
    the eager call."""
    def capture(images):
        def forward(x):
            tracing.mark("exported.begin", x)
            with torch.no_grad():
                out = module(x)
            tracing.mark("exported.end", out)
            return out
        return graphs.Graph(forward, (images,), label="exported forward",
                            model=module)
    return graphs.CompiledStep("exported", capture, maxsize=EXPORT_GRAPHS)


class Exported:
    """A loaded artifact: ``call(images)`` runs it without gradients on
    images on the device it was exported on, at the port's precision there
    (on the card float32 without TF32, which ``resolve_device`` fixes for
    the process: the flags are not part of the graph). On the card each
    input shape's call replays its CUDA graph (:func:`compile_module`)."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.device = resolve_device(
            next(iter(program.state_dict.values())).device)
        self.program = program
        self._module = program.module()
        self.graphs = compile_module(self._module) \
            if self.device.type == "cuda" else None

    def call(self, images: torch.Tensor) -> torch.Tensor:
        """(B, classes) probabilities, a tensor of its own: on the card a
        copy of the graph's output, which the next call overwrites."""
        if self.graphs is not None:
            return self.graphs(images).clone()
        with torch.no_grad():
            return self._module(images)

    def scan_compute(self) -> list:
        """The compute mode of each scan node of the graph, in graph order:
        what the artifact's scans run, whatever ``MEDMAMBA_SCAN_COMPUTE``
        says when it is called."""
        modes = []
        for node in self.program.graph.nodes:
            if node.op != "call_function" or not isinstance(
                    node.target, torch._ops.OpOverload) or \
                    node.target.namespace != "medmamba":
                continue
            args = node.target._schema.arguments
            i = [a.name for a in args].index("compute")
            modes.append(node.kwargs["compute"] if "compute" in node.kwargs
                         else node.args[i] if len(node.args) > i
                         else args[i].default_value)
        return modes


def load_exported(blob: bytes) -> Exported:
    """Deserialize an artifact of :func:`export_forward`."""
    return Exported(torch.export.load(io.BytesIO(blob)))
