"""Grad-CAM test CLI of the PyTorch port (counterpart of
``medmamba_tpu/cli/test.py``, parity with the reference ``test.py``).

Loads a ``.pth`` checkpoint, samples images from a test tree as the JAX CLI
does (``os.walk`` order, ``random.seed(seed)``, ``random.sample``), predicts
each and computes Grad-CAM on the predicted class, at the default target
layer (the last conv-branch 1x1 of the last block, before its ReLU) or at
``--target_layers``. Each ``gradcam_{i}.png`` holds the input and the
overlay side by side, written with ``utils/png.py`` (the JAX CLI draws a
titled matplotlib figure instead). Runs on the card (``--device cuda``, the
default; raises without one), where the softmax forward is one CUDA graph
(``train/trainer.py: compile_forward``) and the Grad-CAM runs eagerly, or,
when asked, on the CPU. A PNG already at
``--image_size`` square is decoded without PIL.

Usage:
    python -m medmamba_tpu_torch.cli.test --checkpoint_path weights.pth \
        --test_dir DIR --num_classes N [--output_dir out --num_images 10]
"""
from __future__ import annotations

import argparse
import os
import random
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MedMamba Grad-CAM test "
                                            "(PyTorch port).")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="a .pth file in the reference schema, or a bare "
                        "state dict")
    p.add_argument("--test_dir", type=str, required=True)
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--medmb_size", type=str, default="T",
                   choices=["T", "S", "B", "Te"])
    p.add_argument("--output_dir", type=str, default="gradcam_outputs")
    p.add_argument("--num_images", type=int, default=10)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--target_layers", type=str, nargs="*", default=None,
                   help="one or more dotted module paths (e.g. "
                        "layers_3.blocks_1.conv1x1); CAMs from multiple "
                        "layers are scaled and averaged "
                        "(grad_cam/utils.py:112-116). Default: the last "
                        "conv1x1 of the conv branch (test.py:101).")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


def main(argv=None):
    """Run the CLI; returns one dict per image: ``path``, ``pred``,
    ``conf``, ``cam`` ((size, size) float32), ``out`` (the PNG) and
    ``seconds`` (from reading the file to writing the PNG)."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from medmamba_tpu_torch.eval.gradcam import grad_cam, show_cam_on_image
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.train.trainer import forward_fn
    from medmamba_tpu_torch.utils import png
    from medmamba_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    model = create_model(args.medmb_size, args.num_classes, device=device)
    state_dict, _ = restore_params(args.checkpoint_path)
    model.load_state_dict(state_dict, strict=True)
    # the batch-1 softmax forward: one CUDA graph on the card
    forward = forward_fn(model, device, image_size=args.image_size)

    paths = []
    for base, _, files in os.walk(args.test_dir):
        for f in files:
            if f.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(base, f))
    random.seed(args.seed)
    paths = random.sample(paths, min(args.num_images, len(paths)))
    if not paths:
        raise SystemExit(f"No images found under {args.test_dir}")
    tpaths = args.target_layers or None

    results = []
    for i, path in enumerate(paths):
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            img = png.load_rgb(f.read(), args.image_size)
        probs, x = forward(torch.from_numpy(img[None]))
        probs = probs[0].cpu().numpy()
        x = x.clone()     # the graph's buffer; the CAM runs eagerly on it
        pred = int(probs.argmax())
        conf = float(probs[pred])

        cam = grad_cam(model, x, target_class=np.array([pred]),
                       target_paths=tpaths)[0]
        overlay = show_cam_on_image(img.astype(np.float32) / 255.0, cam)
        out = os.path.join(args.output_dir, f"gradcam_{i}.png")
        with open(out, "wb") as f:
            f.write(png.encode(np.concatenate([img, overlay], axis=1)))
        print(f"{path} -> class {pred} conf {conf:.3f} saved {out}")
        results.append(dict(path=path, pred=pred, conf=conf, cam=cam,
                            out=out, seconds=time.perf_counter() - t0))
    return results


if __name__ == "__main__":
    main()
