"""Grad-CAM on the CAM backbones (ViT / Swin / MobileNetV2), PyTorch port.

Counterpart of ``medmamba_tpu/cli/cam_backbones.py`` (parity with the
reference's ``grad_cam/main_cnn.py``, ``main_vit.py`` and
``main_swin.py``): ViT-B/16 at ``blocks_11.norm1`` through the cls-dropping
reshape, Swin-T at ``norm``, MobileNetV2 at ``head_conv.conv`` (the head's
1x1 convolution before its BatchNorm), each at ``--image_size`` with
``--num_classes`` outputs. Weights come from a ``.pth`` in the reference
schema (``--checkpoint_path``, read by ``train/checkpoint.py:
restore_params``) or from random init (``--random-ok``, a
``torch.Generator`` seeded 0; a random ViT's head is zeros, so its logits
and CAM are too, as in the JAX package). The model runs in eval mode: the
JAX CLI passes ``True`` as ``apply``'s third argument, which MobileNetV2
reads as ``train`` and then raises; the reference CNN CAM runs it in eval
mode, as here. The image is read with ``utils/png.py: load_rgb`` (a PNG
already at ``--image_size`` square needs no PIL) and preprocessed as the
JAX CLI does; the input and the overlay are written side by side to
``--output`` with ``utils/png.py`` (the JAX CLI draws a titled matplotlib
figure). The forward stays eager: a CUDA graph's capture costs more than
the one forward a process serves. Runs on the card (``--device cuda``, the
default; raises without one) or, when asked, on the CPU.

Usage:
    python -m medmamba_tpu_torch.cli.cam_backbones --arch vit --image img.png \
        [--checkpoint_path W.pth | --random-ok] [--target_category 281]
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=["vit", "swin", "mobilenet"],
                   required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--random-ok", action="store_true",
                   help="allow randomly-initialized weights (smoke test)")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--target_category", type=int, default=None)
    p.add_argument("--output", default="cam_backbone.png")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(arch: str, num_classes: int, image_size: int, generator=None):
    """(model on the CPU, its Grad-CAM target path, reshape_transform) of
    ``--arch``."""
    import functools

    if arch == "vit":
        from medmamba_tpu_torch.models.vit import (vit_base_patch16_224,
                                                   vit_reshape_transform)
        model = vit_base_patch16_224(num_classes, img_size=image_size,
                                     generator=generator)
        return (model, f"blocks_{model.depth - 1}.norm1",
                functools.partial(vit_reshape_transform,
                                  grid=image_size // 16))
    if arch == "swin":
        from medmamba_tpu_torch.models.swin import \
            swin_tiny_patch4_window7_224
        return (swin_tiny_patch4_window7_224(num_classes, generator=generator),
                "norm", None)
    from medmamba_tpu_torch.models.mobilenet import MobileNetV2
    return (MobileNetV2(num_classes, generator=generator), "head_conv.conv",
            None)


def main(argv=None):
    """Run the CLI; returns ``pred``, ``target``, ``logits`` ((num_classes,)
    float32), ``cam`` ((size, size) float32 in [0, 1]) and ``out`` (the
    PNG's path)."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.eval.gradcam import grad_cam, show_cam_on_image
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.utils import png
    from medmamba_tpu_torch.utils.device import resolve_device

    if not (args.checkpoint_path or args.random_ok):
        raise SystemExit("need --checkpoint_path or --random-ok")
    device = resolve_device(args.device)
    model, target_path, reshape_transform = build(
        args.arch, args.num_classes, args.image_size,
        torch.Generator().manual_seed(0))
    if args.checkpoint_path:
        state_dict, _ = restore_params(args.checkpoint_path)
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval()

    with open(args.image, "rb") as f:
        img = png.load_rgb(f.read(), args.image_size)
    x = preprocess(torch.from_numpy(img[None]).to(device),
                   size=args.image_size)
    with torch.no_grad():
        logits = model(x)[0].float().cpu().numpy()
    pred = int(logits.argmax())
    target = args.target_category if args.target_category is not None \
        else pred

    cam = grad_cam(model, x, target_class=np.array([target]),
                   target_paths=[target_path],
                   reshape_transform=reshape_transform)[0]
    overlay = show_cam_on_image(img.astype(np.float32) / 255.0, cam)
    with open(args.output, "wb") as f:
        f.write(png.encode(np.concatenate([img, overlay], axis=1)))
    print(f"{args.arch} CAM target={target} (pred={pred}) saved "
          f"{args.output}")
    return dict(pred=pred, target=target, logits=logits, cam=cam,
                out=args.output)


if __name__ == "__main__":
    main()
