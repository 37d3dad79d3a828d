"""Training trajectories of the port over hundreds of steps.

The port's half of the trajectory harness, the counterpart of the JAX
package's ``tools/trajectory_parity.py``: a check over one step cannot see
drift that only shows over many (the optimizer, the BatchNorm running
statistics, the masked loss, a kernel's small error compounding). The
CPU tests (``tests/torch_port_trajectory.py``) hold these arms against the
JAX package's; the card arms below hold the kernels against the plain scan
and against each other.

* :func:`make_grating_data`: the JAX tool's grating task (class-dependent
  sinusoids under heavy noise, learnable only through spatial filters),
  quantised to uint8 NHWC the same way every time, so both packages'
  ``preprocess`` receive the same bytes.
* :func:`run_arm`: one arm through the production step
  (``train/trainer.py: train_step``, or ``compile_train_step`` as
  ``cli.train`` runs on the card): the loss masking, ``preprocess`` (K5
  when augmenting), BatchNorm, AdamW with the NPZ recipe. It returns the
  per-step losses, the validation accuracy (``trainer.predict``) and the
  final full state dict (``parallel/mesh.py: full_state_dict`` under a
  mesh).
* :func:`smooth` and :func:`final_quarter_gap`: the JAX tool's metric (a
  trailing mean over ``max(10, steps // 25)`` steps, then the mean |Δ|
  over the last quarter of the smoothed curves); :func:`param_gap`: the
  relative L2 distance of two state dicts, per entry and in total.

On the card, from the root of a checkout:

    python -m medmamba_tpu_torch.tools.trajectory OUT_DIR

runs the arms (``--arms``, all by default; the step counts are flags, so
a short call can build and check everything first), writes
``trajectory.json`` (curves included) into ``OUT_DIR``, prints the card's
name and power limit and one JSON line of results without the curves,
and exits 1 where a gate fails:

* ``long``: medmamba_t, 224^2, batch 64, bfloat16 blocks, graphed, with
  augmentation and drop path 0.1, LONG_STEPS steps: "ssd" (K1, K2, K5),
  "hillis" (K3, K4, K5), "noise" ("ssd" from another init seed);
* ``anchor``: medmamba_t at full widths at 32^2, batch 64, float32
  blocks, eager, ANCHOR_STEPS steps: "ssd", "plain" (``scan_impl="ref"``;
  K5 stays, since it is held bit for bit to its plain version), "noise";
* ``gap``: the float32 weight gradients of one process, of two gloo
  ranks on the card and of one process on the batch with its halves
  swapped (a sum order of its own), each against the float64 product gᵀx
  of every unsharded Linear and Conv2d layer's recorded input and output
  gradient in its run, and each layer's input and output gradient of the
  swapped run against one process's (one step, 224^2, batch 64, float32
  blocks, K1/K2, no draws, ``cudnn.deterministic``); then GAP_STEPS eager
  float32 steps at 224^2, a global batch of GAP_BATCH (the 1x2 mesh over
  gloo moves whole activations through the host), of one process, two
  gloo data ranks, a 1x2 model mesh and a "noise" process, the parameter
  gaps taken at GAP_AT.

Every arm of a group trains from one init, on one uint8 stream, with one
generator seed; the draws do not depend on the scan, so they are the same
in every arm. Two arms of each tier are yardsticks: "noise", the first
arm from another init seed, and "jitter", the first arm from the init
moved one unit in the last place (:func:`jittered`), whose distance is
what rounding alone grows to. The gates: each arm's final-quarter loss
gap and parameter gap against its partner ("hillis" against "ssd", "ssd"
against "plain", a mesh against one process) at most GATE_RATIO times
the matching "noise" gap; "jitter"'s readings stand beside them
(``rounding``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from medmamba_tpu_torch.models import vssm
from medmamba_tpu_torch.models.registry import MODEL_CONFIGS
from medmamba_tpu_torch.parallel import mesh as pmesh
from medmamba_tpu_torch.train import trainer
from medmamba_tpu_torch.utils import graphs
from medmamba_tpu_torch.utils.device import resolve_device

KERNEL_ENV = "MEDMAMBA_SCAN_KERNEL"
STATS = ("running_mean", "running_var")
GATE_RATIO = 0.1

# the card arms
SEED, NOISE_SEED, JITTER_SEED = 0, 1, 2
DATA_SEED, VAL_SEED, DRAW_SEED = 11, 12, 13
CLASSES = 9                # 3 frequencies x 3 orientations of the grating
BATCH = 64
N_VAL = 512
LONG_IMAGE, LONG_SIDE, LONG_STEPS = 224, 64, 500
ANCHOR_IMAGE, ANCHOR_STEPS = 32, 300
GAP_STEPS, GAP_BATCH = 200, 16
GAP_AT = (1, 10, 50, 200)
GAP_LAYER = "layers.0.downsample.reduction"
TOP = 5


def make_grating_data(n: int, side: int, classes: int, seed: int):
    """``n`` class-dependent sinusoid gratings under heavy noise (the JAX
    tool's ``tools/trajectory_parity.py: make_grating_data``, the same
    draws), quantised to uint8 NHWC: x in [-2, 2] maps linearly onto
    [0, 255], rounded to nearest, the tails clipped. Returns (images
    (n, side, side, 3) uint8, labels (n,) int64)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    labels = rng.integers(0, classes, size=n)
    freq = 1 + labels % 3
    theta = (labels // 3) * np.pi / 3
    phase = rng.uniform(0, 2 * np.pi, size=n)
    cx = np.cos(theta)[:, None, None]
    cy = np.sin(theta)[:, None, None]
    grating = np.sin(2 * np.pi * freq[:, None, None]
                     * (cx * xx[None] + cy * yy[None]) + phase[:, None, None])
    x = 0.4 * grating[..., None] + 0.5 * rng.standard_normal(
        (n, side, side, 3))
    images = np.clip(np.rint((x + 2.0) * (255.0 / 4.0)), 0, 255)
    return images.astype(np.uint8), labels.astype(np.int64)


def grating_stream(steps: int, batch: int, side: int, classes: int,
                   seed: int):
    """``steps`` batches of ``batch`` gratings: (images (steps, batch,
    side, side, 3) uint8, labels (steps, batch) int64)."""
    images, labels = make_grating_data(steps * batch, side, classes, seed)
    return (images.reshape(steps, batch, side, side, 3),
            labels.reshape(steps, batch))


def smooth_window(steps: int) -> int:
    return max(10, steps // 25)


def smooth(curve, w: int) -> np.ndarray:
    """Trailing-window mean: step-level jitter seeded by rounding is
    expected to grow; the smoothed trend is what a wiring or optimizer
    fault would bend."""
    return np.convolve(np.asarray(curve, np.float64), np.ones(w) / w,
                       mode="valid")


def final_quarter_gap(a, b) -> float:
    """Mean |a - b| over the last quarter of the two smoothed curves."""
    w = smooth_window(len(a))
    sa, sb = smooth(a, w), smooth(b, w)
    q = max(1, len(sa) // 4)
    return float(np.abs(sa[-q:] - sb[-q:]).mean())


def stat_names(state: Dict[str, torch.Tensor]) -> list:
    return [k for k in state if k.endswith(STATS)]


def param_names(state: Dict[str, torch.Tensor]) -> list:
    return [k for k, v in state.items()
            if v.is_floating_point() and not k.endswith(STATS)]


def param_gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
              keys: Optional[Sequence[str]] = None) -> dict:
    """||a - b|| / ||b|| of two state dicts: per entry and in total over
    ``keys`` (the parameters by default)."""
    keys = param_names(b) if keys is None else list(keys)
    per, num, den = {}, 0.0, 0.0
    for k in keys:
        x = a[k].detach().double().cpu()
        y = b[k].detach().double().cpu()
        d2, n2 = float((x - y).square().sum()), float(y.square().sum())
        per[k] = d2 ** 0.5 / max(n2 ** 0.5, 1e-300)
        num, den = num + d2, den + n2
    return dict(total=(num / max(den, 1e-300)) ** 0.5, per=per)


@contextlib.contextmanager
def kernel_env(name: Optional[str]):
    """``MEDMAMBA_SCAN_KERNEL`` set to ``name`` within the block (left as
    it is for None), restored after it."""
    saved = os.environ.get(KERNEL_ENV)
    if name is not None:
        os.environ[KERNEL_ENV] = name
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(KERNEL_ENV, None)
        else:
            os.environ[KERNEL_ENV] = saved


def _model_ranks(grid) -> int:
    group = pmesh.model_group(grid)
    return 1 if group is None else torch.distributed.get_world_size(group)


def full_state(model: torch.nn.Module, grid=None) -> dict:
    """The whole state dict on the CPU, shards gathered under a model
    axis (a collective of the model group)."""
    state = (pmesh.full_state_dict(model) if _model_ranks(grid) > 1
             else model.state_dict())
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def accuracy(model: torch.nn.Module, images, labels, *, image_size: int,
             batch: int) -> float:
    """Top-1 accuracy of ``trainer.predict`` on uint8 NHWC ``images``."""
    device = next(model.parameters()).device
    correct = 0
    for j in range(0, len(images), batch):
        probs, _ = trainer.predict(
            model, torch.as_tensor(images[j:j + batch]).to(device),
            image_size=image_size)
        correct += int((probs.argmax(-1).cpu()
                        == torch.as_tensor(labels[j:j + batch])).sum())
    return correct / len(images)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_arm(model_kw: dict, state_dict: Dict[str, torch.Tensor], batches,
            labels, *, device, scan_impl: str = "auto",
            scan_kernel: Optional[str] = None, dtype=torch.float32,
            augment: bool = False, seed: int = 0, mesh=None,
            graphed: bool = False, image_size: Optional[int] = None,
            val=None, keep: Sequence[int] = ()) -> dict:
    """Train ``VSSM(**model_kw, scan_impl=scan_impl, dtype=dtype)`` from
    ``state_dict`` for one step a batch of ``batches`` (uint8 NHWC, (steps,
    batch, H, W, 3), numpy or CPU tensor) and ``labels`` ((steps,
    batch)), with AdamW's NPZ recipe (lr 1e-3) and the draws from a
    generator on ``device`` seeded ``seed``; ``scan_kernel`` sets
    ``MEDMAMBA_SCAN_KERNEL`` for the arm. Under ``mesh`` (this rank's
    active mesh) the rank steps on its data row's slice of each global
    batch, its parameters partitioned over the model axis. ``graphed``:
    the steps as ``compile_train_step``'s CUDA graph (the card only).
    ``val``: (images, labels) for the accuracy after the last step;
    ``keep``: the steps after which the whole state is kept.

    Returns ``losses`` (numpy float64, the global batch's), ``acc`` (or
    None), ``state`` (the whole final state dict on the CPU), ``kept``
    ({step: state}), ``ms_per_step`` (wall over the steps after the first,
    with one sync at each end), ``first_s`` (the first step's wall:
    capture included when graphed) and ``counts`` (the kernels' launches,
    ``utils/graphs.py: read_counts``, over the arm's steps)."""
    device = resolve_device(device)
    image_size = batches.shape[2] if image_size is None else image_size
    model = vssm.VSSM(**model_kw, scan_impl=scan_impl, dtype=dtype).to(device)
    if _model_ranks(mesh) > 1:
        pmesh.partition_params(model, mesh)
    model.load_state_dict(state_dict)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    index, count = pmesh.process_slice(mesh)
    rows = batches.shape[1] // count
    part = slice(index * rows, (index + 1) * rows)
    keep = set(keep)
    with kernel_env(scan_kernel):
        gen = torch.Generator(device=device).manual_seed(seed)
        step = (trainer.compile_train_step(model, opt, generator=gen)
                if graphed else None)
        losses, kept = [], {}
        before = graphs.read_counts()
        t0 = t1 = time.perf_counter()
        for i in range(len(batches)):
            im = torch.as_tensor(batches[i][part]).to(device)
            lb = torch.as_tensor(labels[i][part]).to(device)
            if step is None:
                loss = trainer.train_step(model, opt, im, lb, generator=gen,
                                          augment=augment,
                                          image_size=image_size)
            else:
                loss = step(im, lb, augment=augment,
                            image_size=image_size).clone()
            losses.append(loss)
            if i == 0:
                _sync(device)
                t1 = time.perf_counter()
            if i + 1 in keep:
                kept[i + 1] = full_state(model, mesh)
        _sync(device)
        t2 = time.perf_counter()
        after = graphs.read_counts()
        acc = None if val is None else accuracy(
            model, *val, image_size=image_size, batch=batches.shape[1])
        state = full_state(model, mesh)
        if step is not None:
            step.free()
    return dict(losses=torch.stack(losses).double().cpu().numpy(), acc=acc,
                state=state, kept=kept, first_s=t1 - t0,
                ms_per_step=1e3 * (t2 - t1) / max(1, len(batches) - 1),
                counts={k: after[k] - before[k] for k in before})


def compare(arm: dict, partner: dict, noise: dict) -> dict:
    """The gates' readings of ``arm`` against ``partner``, each beside the
    ``noise`` arm's against ``partner``: the final-quarter loss gap, the
    parameters' and the BatchNorm statistics' relative L2 gaps, and the
    first 5 losses' largest relative difference. Losses may be arrays or
    tensors."""
    arm, partner, noise = (dict(a, losses=np.asarray(a["losses"],
                                                     np.float64))
                           for a in (arm, partner, noise))
    out = {}
    first = partner["losses"][:5]
    out["first5_loss_rel"] = float(np.max(np.abs(arm["losses"][:5] - first)
                                          / np.abs(first)))
    pairs = (("loss_gap", lambda a: final_quarter_gap(
        a["losses"], partner["losses"])),
        ("param_gap", lambda a: param_gap(a["state"], partner["state"])
         ["total"]),
        ("stats_gap", lambda a: param_gap(
            a["state"], partner["state"], stat_names(partner["state"]))
         ["total"]))
    for name, f in pairs:
        got, yard = f(arm), f(noise)
        out[name] = got
        out[f"noise_{name}"] = yard
        out[f"{name}_ratio"] = got / max(yard, 1e-300)
    return out


# ---------------------------------------------------------------------------
# C2: float32 weight gradients against float64 ones
# ---------------------------------------------------------------------------


class GemmRecorder:
    """Within the block, every unsharded Linear and Conv2d layer of
    ``model`` that a forward runs (``models/vssm.py: _linear``, ``_conv``)
    adds, in the backward, the float64 gradient of its weight (and bias)
    computed from its input and its output's gradient to ``grads64``: gᵀx
    summed over every row for a Linear layer, the convolution's weight
    gradient for a Conv2d one. The layers named in ``keep`` (every layer
    for "all") also keep that input and output gradient as they were, in
    ``inputs`` and ``out_grads`` (the batch first), in forward order."""

    def __init__(self, model: torch.nn.Module, keep=()):
        self.names = {m: n for n, m in model.named_modules()}
        self.keep = keep
        self.grads64: Dict[str, torch.Tensor] = {}
        self.inputs: Dict[str, torch.Tensor] = {}
        self.out_grads: Dict[str, torch.Tensor] = {}

    def _add(self, name: str, g: torch.Tensor) -> None:
        self.grads64[name] = self.grads64.get(name, 0) + g

    def _record(self, layer, x, y):
        """(the layer's name, x in its dtype) where ``layer`` is recorded
        on this call, else None."""
        name = self.names.get(layer)
        if name is None or pmesh.model_shard(layer.weight) is not None \
                or not y.requires_grad:
            return None
        x = x.detach().to(y.dtype)
        if self.keep == "all" or name in self.keep:
            self.inputs[name] = x

            def keep_grad(g):
                self.out_grads[name] = g.detach()
            y.register_hook(keep_grad)
        return name, x

    def _linear(self, layer, x, dtype):
        y = self._real_linear(layer, x, dtype)
        rec = self._record(layer, x, y)
        if rec is None:
            return y
        name, x = rec
        x64 = x.double().reshape(-1, x.shape[-1])

        def hook(g):
            g64 = g.double().reshape(-1, g.shape[-1])
            self._add(f"{name}.weight", g64.T @ x64)
            if layer.bias is not None:
                self._add(f"{name}.bias", g64.sum(0))
        y.register_hook(hook)
        return y

    def _conv(self, layer, x, dtype):
        y = self._real_conv(layer, x, dtype)
        rec = self._record(layer, x, y)
        if rec is None:
            return y
        name, x = rec
        x64 = x.double()

        def hook(g):
            g64 = g.double()
            self._add(f"{name}.weight", torch.nn.grad.conv2d_weight(
                x64, layer.weight.shape, g64, layer.stride, layer.padding,
                layer.dilation, layer.groups))
            if layer.bias is not None:
                self._add(f"{name}.bias", g64.sum((0, 2, 3)))
        y.register_hook(hook)
        return y

    def __enter__(self):
        self._real_linear, self._real_conv = vssm._linear, vssm._conv
        vssm._linear, vssm._conv = self._linear, self._conv
        return self

    def __exit__(self, *exc):
        vssm._linear, vssm._conv = self._real_linear, self._real_conv
        return False


def swap_halves(n: int) -> torch.Tensor:
    """The order that puts the second half of ``n`` rows first: its own
    inverse."""
    return torch.cat([torch.arange(n // 2, n), torch.arange(n // 2)])


def recorded_step(model_kw, weights, images, labels, *, image_size: int,
                  grid=None, order=None, keep=(), device="cuda") -> dict:
    """One eager float32 ``train_step`` of a fresh model from ``weights``
    (``model_kw``'s drop path 0, no augmentation, so no draw) on this
    rank's slice of the batch (the whole batch without ``grid``; its rows
    taken in ``order`` where given), under ``cudnn.deterministic``: the
    loss, the float32 gradients AdamW is given (summed over the ranks) and
    this rank's :class:`GemmRecorder` readings (float64 weight gradients;
    the inputs and output gradients of the layers in ``keep``, on the card
    for "all", else on the CPU). ``device``: "cuda" for this rank's card;
    the CPU for a rehearsal."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if device == "cuda" else torch.device(device))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    model = vssm.VSSM(**dict(model_kw, drop_path_rate=0.0)).to(device)
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    grads = {}
    names = {p: n for n, p in model.named_parameters()}
    opt.register_step_pre_hook(lambda o, *_: grads.update(
        {names[p]: p.grad.detach().double().cpu()
         for g in o.param_groups for p in g["params"]
         if p.grad is not None}))
    if order is not None:
        images, labels = images[order], labels[order]
    index, count = pmesh.process_slice(grid)
    rows = images.shape[0] // count
    part = slice(index * rows, (index + 1) * rows)
    try:
        with GemmRecorder(model, keep) as rec:
            loss = trainer.train_step(
                model, opt, images[part].to(device), labels[part].to(device),
                generator=torch.Generator(device=device).manual_seed(0),
                augment=False, image_size=image_size)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def place(t):
        return t if keep == "all" else t.cpu()
    return dict(loss=float(loss), grads=grads,
                grads64={k: v.cpu() for k, v in rec.grads64.items()},
                inputs={k: place(v) for k, v in rec.inputs.items()},
                out_grads={k: place(v) for k, v in rec.out_grads.items()})


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double().to(a.device)
    return float((a - b).norm()) / max(float(b.norm()), 1e-300)


def layer_gaps(one: dict, other: dict, order=None) -> list:
    """For each layer both runs kept, in forward order: the relative L2
    distance of ``other``'s input and output gradient from ``one``'s (its
    rows put back where ``order`` moved them)."""
    out = []
    for name, x in one["inputs"].items():
        xo, go = other["inputs"][name], other["out_grads"][name]
        if order is not None:
            back = torch.argsort(order).to(xo.device)
            xo, go = xo[back], go[back]
        out.append((name, _rel(xo, x), _rel(go, one["out_grads"][name])))
    return out


def gemm_report(one: dict, runs: Dict[str, Sequence[dict]]) -> dict:
    """C2's first-step reading. For each of ``runs`` (``"ranks"``: the two
    ranks' records; ``"swapped"``: one process on the batch with its
    halves swapped, a sum order the ranks do not share): its gradient's
    gap against one process's, in total and for the TOP parameters that
    carry most of the ranks' gap and GAP_LAYER's weight; for each, where
    it has a float64 gradient, the distance of each float32 gradient from
    its own run's float64 one, and of the float64 ones from each other
    (relative to the one-process float64 norm); and GAP_LAYER's input and
    output gradient against one process's."""
    g1 = one["grads"]
    norm1 = sum(float(v.square().sum()) for v in g1.values()) ** 0.5
    out = dict(loss_one=one["loss"], params={})
    sq = {}
    for run, recs in runs.items():
        g2 = recs[0]["grads"]
        sq[run] = {k: float((g2[k] - g1[k]).square().sum()) for k in g1}
        out[f"loss_{run}"] = recs[0]["loss"]
        out[f"total_gap_{run}"] = sum(sq[run].values()) ** 0.5 / norm1
        inputs = torch.cat([r["inputs"][GAP_LAYER] for r in recs])
        grads = torch.cat([r["out_grads"][GAP_LAYER] for r in recs])
        back = torch.argsort(swap_halves(len(inputs))) \
            if run == "swapped" else slice(None)
        out[f"{GAP_LAYER}_{run}"] = dict(
            input_gap=_rel(inputs[back], one["inputs"][GAP_LAYER]),
            out_grad_gap=_rel(grads[back], one["out_grads"][GAP_LAYER]))
    top = sorted(sq["ranks"], key=sq["ranks"].get, reverse=True)[:TOP]
    for k in dict.fromkeys(top + [f"{GAP_LAYER}.weight"]):
        n1 = max(float(g1[k].norm()), 1e-300)
        row = {}
        for run, recs in runs.items():
            total = sum(sq[run].values())
            row[f"share_{run}"] = sq[run][k] / max(total, 1e-300)
            row[f"gap_{run}"] = sq[run][k] ** 0.5 / n1
            if k in one["grads64"]:
                a64 = one["grads64"][k]
                b64 = sum(r["grads64"][k] for r in recs)
                ref = max(float(a64.norm()), 1e-300)
                row["one_vs_f64"] = float((g1[k] - a64).norm()) / ref
                row[f"{run}_vs_f64"] = float(
                    (recs[0]["grads"][k] - b64).norm()) / ref
                row[f"f64_apart_{run}"] = float((b64 - a64).norm()) / ref
        out["params"][k] = row
    return out


# ---------------------------------------------------------------------------
# The card arms
# ---------------------------------------------------------------------------


def medmamba_t_kw() -> dict:
    cfg = MODEL_CONFIGS["T"]
    return dict(num_classes=CLASSES, depths=cfg.depths, dims=cfg.dims,
                d_state=cfg.d_state, drop_path_rate=cfg.drop_path_rate)


def init_weights(seed: int) -> dict:
    return vssm.VSSM(**medmamba_t_kw(), generator=torch.Generator()
                     .manual_seed(seed)).state_dict()


def jittered(weights: Dict[str, torch.Tensor],
             seed: int = JITTER_SEED) -> dict:
    """``weights`` with every floating entry moved one unit in the last
    place, up or down at random: a perturbation of rounding size, whose
    run's distance from the unmoved run is the rounding yardstick beside
    the seed-noise one."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in weights.items():
        if v.is_floating_point():
            up = torch.rand(v.shape, generator=gen) < 0.5
            v = torch.nextafter(v, torch.where(
                up, torch.tensor(float("inf")), torch.tensor(float("-inf"))))
        out[k] = v
    return out


def _summary(arm: dict) -> dict:
    return {k: arm[k] for k in ("acc", "ms_per_step", "first_s", "counts")}


def _per_step(counts: dict, steps: int) -> dict:
    return {k: v / steps for k, v in counts.items() if v}


def long_arms(data, val) -> dict:
    """The long tier (see the module's docstring)."""
    kw = dict(device="cuda", dtype=torch.bfloat16, augment=True,
              seed=DRAW_SEED, graphed=True, image_size=LONG_IMAGE, val=val,
              scan_kernel="ssd")
    model_kw, w = medmamba_t_kw(), init_weights(SEED)
    arms = {"ssd": run_arm(model_kw, w, *data, **kw),
            "hillis": run_arm(model_kw, w, *data,
                              **dict(kw, scan_kernel="hillis")),
            "noise": run_arm(model_kw, init_weights(NOISE_SEED), *data,
                             **kw),
            "jitter": run_arm(model_kw, jittered(w), *data, **kw)}
    return dict(arms=arms, pairs={"hillis_vs_ssd": compare(
        arms["hillis"], arms["ssd"], arms["noise"])},
        rounding={"jitter_vs_ssd": compare(arms["jitter"], arms["ssd"],
                                           arms["noise"])})


def anchor_arms(steps: int) -> dict:
    """The anchor tier (see the module's docstring)."""
    data = grating_stream(steps, BATCH, ANCHOR_IMAGE, CLASSES, DATA_SEED)
    val = make_grating_data(N_VAL, ANCHOR_IMAGE, CLASSES, VAL_SEED)
    kw = dict(device="cuda", augment=True, seed=DRAW_SEED, val=val,
              scan_kernel="ssd")
    model_kw, w = medmamba_t_kw(), init_weights(SEED)
    arms = {"ssd": run_arm(model_kw, w, *data, **kw),
            "plain": run_arm(model_kw, w, *data, scan_impl="ref", **kw),
            "noise": run_arm(model_kw, init_weights(NOISE_SEED), *data,
                             **kw),
            "jitter": run_arm(model_kw, jittered(w), *data, **kw)}
    return dict(arms=arms, pairs={"ssd_vs_plain": compare(
        arms["ssd"], arms["plain"], arms["noise"])},
        rounding={"jitter_vs_ssd": compare(arms["jitter"], arms["ssd"],
                                           arms["noise"])})


def _gap_rank(rank: int, world: int, root: str, record, data, keep) -> None:
    """A gloo rank on card 0 for the gap tier: the recorded step and the
    trajectory on the 2x1 data mesh, then the trajectory on the 1x2 model
    mesh; each writes ``gap_rank<rank>.pt`` into ``root`` (rank 1 only its
    recorded step: the ranks' states are the same)."""
    grid = pmesh.make_mesh(device=torch.device("cuda", 0), rank=rank,
                           world_size=world, backend="gloo",
                           init_method=f"file://{root}/rendezvous")
    kw = dict(device="cuda", augment=True, seed=DRAW_SEED,
              image_size=LONG_IMAGE, keep=keep, scan_kernel="ssd")
    try:
        out = dict(record=recorded_step(*record, image_size=LONG_IMAGE,
                                        grid=grid, keep=(GAP_LAYER,)))
        torch.backends.cudnn.deterministic = True
        model_kw, w = record[0], record[1]
        out["data"] = run_arm(model_kw, w, *data, mesh=grid, **kw)
        tp = pmesh.make_mesh(n_model=2, device=torch.device("cuda", 0))
        out["model"] = run_arm(model_kw, w, *data, mesh=tp, **kw)
        if rank != 0:
            out = dict(record=out["record"])
        torch.save(out, os.path.join(root, f"gap_rank{rank}.pt"))
    finally:
        pmesh.destroy_mesh()


def _spawn(fn, world: int, *args) -> None:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"gap ranks exited {[p.exitcode for p in procs]}")


def gap_arms(steps: int, data_all, batch: int) -> dict:
    """The gap tier (see the module's docstring)."""
    model_kw, w = medmamba_t_kw(), init_weights(SEED)
    images = torch.as_tensor(data_all[0][0])
    labels = torch.as_tensor(data_all[1][0])
    record = (model_kw, w, images, labels)
    one = recorded_step(*record, image_size=LONG_IMAGE, keep="all")
    order = swap_halves(len(images))
    swapped = recorded_step(*record, image_size=LONG_IMAGE, keep="all",
                            order=order)
    layers = layer_gaps(one, swapped, order)
    for rec in (one, swapped):
        rec["inputs"] = {GAP_LAYER: rec["inputs"][GAP_LAYER].cpu()}
        rec["out_grads"] = {GAP_LAYER: rec["out_grads"][GAP_LAYER].cpu()}
    torch.cuda.empty_cache()
    data = (data_all[0][:steps, :batch], data_all[1][:steps, :batch])
    keep = tuple(s for s in GAP_AT if s < steps) + (steps,)
    kw = dict(device="cuda", augment=True, seed=DRAW_SEED,
              image_size=LONG_IMAGE, keep=keep, scan_kernel="ssd")
    torch.backends.cudnn.deterministic = True
    try:
        arms = {"one": run_arm(model_kw, w, *data, **kw),
                "noise": run_arm(model_kw, init_weights(NOISE_SEED), *data,
                                 **kw),
                "jitter": run_arm(model_kw, jittered(w), *data, **kw)}
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        _spawn(_gap_rank, 2, root, record, data, keep)
        ranks = [torch.load(os.path.join(root, f"gap_rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    arms["data"], arms["model"] = ranks[0]["data"], ranks[0]["model"]
    report = gemm_report(one, {"ranks": [r["record"] for r in ranks],
                               "swapped": [swapped]})
    report["swapped_layers"] = layers
    gaps = {}
    for name in ("data", "model", "noise", "jitter"):
        gaps[name] = {s: param_gap(arms[name]["kept"][s],
                                   arms["one"]["kept"][s])["total"]
                      for s in keep}
    pairs = {f"{name}_vs_one": compare(arms[name], arms["one"],
                                       arms["noise"])
             for name in ("data", "model")}
    return dict(arms=arms, pairs=pairs, param_gap_at=gaps, gemm=report,
                batch=batch, rounding={"jitter_vs_one": compare(
                    arms["jitter"], arms["one"], arms["noise"])})


def gates(result: dict) -> dict:
    """Each pair's loss and parameter gap ratios against GATE_RATIO."""
    out = {}
    for tier in result.values():
        for name, c in tier.get("pairs", {}).items():
            for key in ("loss_gap_ratio", "param_gap_ratio"):
                out[f"{name}.{key}"] = c[key] <= GATE_RATIO
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--arms", default="long,anchor,gap")
    p.add_argument("--long_steps", type=int, default=LONG_STEPS)
    p.add_argument("--anchor_steps", type=int, default=ANCHOR_STEPS)
    p.add_argument("--gap_steps", type=int, default=GAP_STEPS)
    args = p.parse_args(argv)
    resolve_device("cuda")
    from medmamba_tpu_torch.ops import cuda_build, rotate, scan_cuda, \
        scan_hillis

    t0 = time.perf_counter()
    cuda_build.build(scan_cuda.FWD_SOURCE, scan_cuda.BWD_SOURCE,
                     rotate.SOURCE, scan_hillis.FWD_SOURCE,
                     scan_hillis.BWD_SOURCE)
    seconds = {"build": time.perf_counter() - t0}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    arms = args.arms.split(",")
    steps = max(args.long_steps if "long" in arms else 0,
                args.gap_steps if "gap" in arms else 0)
    result = {}
    if steps:
        t0 = time.perf_counter()
        data = grating_stream(steps, BATCH, LONG_SIDE, CLASSES, DATA_SEED)
        val = make_grating_data(N_VAL, LONG_SIDE, CLASSES, VAL_SEED)
        seconds["data"] = time.perf_counter() - t0
    for name in arms:
        t0 = time.perf_counter()
        if name == "long":
            result[name] = long_arms((data[0][:args.long_steps],
                                      data[1][:args.long_steps]), val)
        elif name == "anchor":
            result[name] = anchor_arms(args.anchor_steps)
        elif name == "gap":
            result[name] = gap_arms(args.gap_steps, data, GAP_BATCH)
        else:
            raise SystemExit(f"unknown arm group {name!r}")
        seconds[name] = time.perf_counter() - t0
        print(f"{name}: {seconds[name]:.1f} s", flush=True)
    ok = gates(result)
    os.makedirs(args.out_dir, exist_ok=True)
    full = {tier: {k: v for k, v in r.items() if k != "arms"}
            for tier, r in result.items()}
    for tier, r in result.items():
        full[tier]["arms"] = {
            name: dict(_summary(a), losses=a["losses"].tolist(),
                       launches_per_step=_per_step(a["counts"],
                                                   len(a["losses"])))
            for name, a in r["arms"].items()}
    full.update(gates=ok, seconds=seconds, device=smi)
    with open(os.path.join(args.out_dir, "trajectory.json"), "w") as f:
        json.dump(full, f)
    for tier in full.values():
        if isinstance(tier, dict):
            for a in tier.get("arms", {}).values():
                a.pop("losses", None)
            tier.get("gemm", {}).pop("swapped_layers", None)
    print(json.dumps(full), flush=True)
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
