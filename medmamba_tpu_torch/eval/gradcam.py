"""Grad-CAM for the port's models (counterpart of
``medmamba_tpu/eval/gradcam.py``): the VSSM, and the CAM backbones of
``cli.cam_backbones`` (ViT, Swin, MobileNetV2), each of which names its
activations by their JAX module paths through its ``tap_site``.

The same maths as the JAX package (grad_cam/utils.py:52-175 + test.py:99-121
of the reference):
  * the target layer defaults to the last Conv1x1 of the conv branch in the
    last block of the last stage (``layers_{-1}.blocks_{-1}.conv1x1``, taken
    before its ReLU);
  * weights = gradient mean over (H, W); cam = ReLU(sum_c w_c * act_c);
    per-image min-max rescale and bilinear resize to the input size;
  * loss = sum of the target-class logits over the batch.

The activations come from the model's taps (``VSSM.tap_site``, and the
backbones' ``tap_site``). During the CAM forward no parameter requires a
gradient, and the loss is differentiated with respect to the tapped
activations only, as the JAX program
differentiates only with respect to zero perturbations of them. So the
backward runs only through what lies downstream of the targets: on the card,
K2 launches only for the scans between a target and the logits.

The JAX module caches its jitted programs (``_LRU``); eager PyTorch has no
program to cache, so there is no counterpart.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from medmamba_tpu_torch.data.transforms import resize

# matplotlib's "jet" (matplotlib/_cm.py: _jet_data), as (x, y0, y1) segments
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
JET_N = 256


def _lookup_table(n: int, data) -> np.ndarray:
    """One channel of a segmented colormap at ``n`` entries, as matplotlib's
    ``colors._create_lookup_table`` computes it (gamma 1)."""
    adata = np.array(data)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


# (256, 3) float64: the RGB entries of matplotlib's ``cm.jet``
JET_LUT = np.stack([_lookup_table(JET_N, _JET[c])
                    for c in ("red", "green", "blue")], axis=1)


def jet(mask: np.ndarray) -> np.ndarray:
    """``cm.jet(mask)[..., :3]`` for a float mask: each value scaled by 256
    in its own dtype and truncated to an entry (1.0 takes the last; below 0
    the first, from 1 on the last); NaN is black."""
    xa = np.array(mask, copy=True)
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    under, over, bad = xa < 0, xa >= JET_N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = JET_N - 1
    idx[bad] = 0
    heat = JET_LUT[idx]
    heat[bad] = 0.0
    return heat


def default_target_path(model) -> Tuple[str, ...]:
    """layers[-1].blocks[-1].conv1x1 (cf. test.py:101)."""
    n_stages = len(model.layers)
    last_block = len(model.layers[-1].blocks) - 1
    return (f"layers_{n_stages - 1}", f"blocks_{last_block}", "conv1x1")


def block_paths(model) -> list:
    """The tap paths of every block's output, ``layers_i.blocks_j``."""
    return [f"layers_{i}.blocks_{j}" for i, layer in enumerate(model.layers)
            for j in range(len(layer.blocks))]


class _Substitute(torch.autograd.Function):
    """``value`` in the forward; in the backward the gradient goes on to
    ``x`` unchanged, so what lies upstream of ``x`` keeps its path to the
    loss."""

    @staticmethod
    def forward(ctx, x, value):
        return value.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def _tapped(model, target_paths: Sequence, callback):
    """Within the block the activation (NHWC) at each of ``target_paths``
    flows on as ``callback(key, x)``. Yields the paths' keys, one per tap
    site, so two names of one site share a key."""
    sites = [model.tap_site(p) for p in target_paths]
    keys = [(id(module), point) for module, point in sites]
    for (module, point), key in zip(sites, keys):
        module.taps[point] = functools.partial(callback, key)
    try:
        yield keys
    finally:
        for module, point in sites:
            module.taps.pop(point, None)


def target_activations(model, images: torch.Tensor,
                       target_paths: Sequence) -> list:
    """The activations at ``target_paths`` (NHWC, as the CAM weights them)
    in one forward of ``model`` as it stands, without gradients."""
    acts = {}

    def keep(key, x):
        acts[key] = x.detach().clone()
        return x
    with _tapped(model, target_paths, keep) as keys, torch.no_grad():
        model(images)
    return [acts[k] for k in keys]


def _scale(cam: torch.Tensor) -> torch.Tensor:
    """Per-image min-max rescale (grad_cam/utils.py:118-127)."""
    cam = cam - cam.amin(dim=(1, 2), keepdim=True)
    return cam / (1e-7 + cam.amax(dim=(1, 2), keepdim=True))


def grad_cam(model, images: torch.Tensor,
             target_class=None,
             target_path: Optional[Sequence[str]] = None,
             target_paths: Optional[Sequence] = None,
             reshape_transform=None,
             substitute: Optional[dict] = None) -> np.ndarray:
    """Grad-CAM heatmaps of ``model`` (on the device of ``images``).

    images: preprocessed float NHWC batch, made outside
    ``torch.inference_mode``. target_class: ints (B,) or None (the predicted
    class, from one more forward). ``target_paths``: several target layers
    (paths as ``VSSM.tap_site`` takes them), whose CAMs are min-max scaled,
    averaged and scaled again (grad_cam/utils.py:112-116); ``target_path``
    is the one-layer shorthand. ``reshape_transform`` maps a token-shaped
    activation and its gradient to NHWC. The model runs in eval mode, as the
    JAX program runs it deterministic; its training flag and its
    parameters' ``requires_grad`` are restored afterwards.
    ``substitute``: {path: NHWC tensor}, at targets or at other tap sites;
    each tensor takes the place of the model's own activation there in the
    CAM forward (the gradient passes through to the model's own), as
    ``target_activations`` returns them from another model. Two models'
    CAMs can so be compared at the same activations: given at every block's
    output and at the targets, every ReLU masks the same elements in both.
    Returns (B, H, W) float32 in [0, 1].
    """
    if target_paths is None:
        target_paths = [target_path or default_target_path(model)]
    b, h_in, w_in, _ = images.shape
    was_training = model.training
    params = list(model.parameters())
    flags = [p.requires_grad for p in params]
    substitute = substitute or {}
    acts, subs, targets = {}, {}, set()

    def capture(key, x):
        if key in targets and not x.requires_grad:
            x = x.detach().requires_grad_(True)
        if key in subs:
            x = _Substitute.apply(x, subs[key].to(x))
        if key in targets:
            acts[key] = x
        return x

    model.eval()
    try:
        if target_class is None:
            with torch.no_grad():
                target_class = model(images).argmax(-1)
        target = torch.as_tensor(target_class).long().to(images.device)
        for p in params:
            p.requires_grad_(False)
        n = len(target_paths)
        with _tapped(model, [*target_paths, *substitute], capture) as keys, \
                torch.enable_grad():
            subs.update(zip(keys[n:], substitute.values()))
            keys = keys[:n]
            targets.update(keys)
            logits = model(images)
            loss = logits.gather(1, target[:, None]).sum()
            grads = torch.autograd.grad(loss, [acts[k] for k in keys])
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
        model.train(was_training)

    cams = []
    with torch.no_grad():
        for g, key in zip(grads, keys):
            act = acts[key].detach()
            if reshape_transform is not None:
                g = reshape_transform(g)
                act = reshape_transform(act)
            weights = g.mean(dim=(1, 2), keepdim=True)            # (B,1,1,C)
            cam = torch.clamp_min((weights * act).sum(-1), 0.0)   # (B,h,w)
            cam = resize(cam.float()[..., None], (h_in, w_in))[..., 0]
            cams.append(_scale(cam))
        cam = _scale(torch.stack(cams, 1).mean(1))
    return cam.cpu().numpy().astype(np.float32)


def show_cam_on_image(img: np.ndarray, mask: np.ndarray,
                      use_rgb: bool = True, image_weight: float = 0.5
                      ) -> np.ndarray:
    """Overlay a [0,1] heatmap on a [0,1] RGB image with the jet colormap
    (grad_cam/utils.py:178-203 behavior; the JAX package's arithmetic with
    its own copy of the colormap, so no matplotlib is needed)."""
    if img.max() > 1.0 + 1e-6 or img.min() < -1e-6:
        raise ValueError("show_cam_on_image expects img scaled to [0, 1]")
    heat = jet(mask)
    if not use_rgb:
        heat = heat[..., ::-1]
    out = (1 - image_weight) * heat + image_weight * img
    out = out / max(out.max(), 1e-7)
    return np.uint8(255 * out)


def center_crop_img(img: np.ndarray, size: int) -> np.ndarray:
    """Aspect-preserving resize + center crop (grad_cam/utils.py:206-230);
    needs PIL, imported here as the JAX package imports it."""
    from PIL import Image

    h, w = img.shape[:2]
    if w > h:
        nh, nw = size, int(w * size / h)
    else:
        nh, nw = int(h * size / w), size
    im = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(im)
    y0 = (nh - size) // 2
    x0 = (nw - size) // 2
    return arr[y0:y0 + size, x0:x0 + size]
