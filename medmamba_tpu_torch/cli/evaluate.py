"""Confusion-matrix / metrics evaluation CLI of the PyTorch port.

Counterpart of ``medmamba_tpu/cli/evaluate.py``: load a ``.pth`` checkpoint,
evaluate a val/test split, print overall accuracy, per-class
precision/sensitivity/specificity/F1 and macro AUC, and optionally save the
heatmap. Runs on the card (``--device cuda``, the default; raises without
one), where the softmax forward is one CUDA graph
(``train/trainer.py: compile_forward``), or, when asked, eagerly on the
CPU.

Usage:
    python -m medmamba_tpu_torch.cli.evaluate --checkpoint_path weights.pth \
        --data_dir DIR [--split test --medmb_size T --batch_size 64 --plot cm.png]
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MedMamba metric evaluation "
                                            "(PyTorch port).")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="a .pth file in the reference schema, or a bare "
                        "state dict")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--medmb_size", type=str, default="T",
                   choices=["T", "S", "B", "Te"])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--plot", type=str, default=None)
    p.add_argument("--scan_tau", type=str, default="auto",
                   choices=["auto", "16", "32", "64", "128"],
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here (the scan is exact).")
    p.add_argument("--tau_gate", type=str, default="outcome",
                   choices=["outcome", "exact"],
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here.")
    p.add_argument("--imagenet_preproc", action="store_true", default=False,
                   help="Resize(256)+CenterCrop+ImageNet mean/std (the "
                        "reference ConfusionMatrix script's recipe); default "
                        "is the training recipe (resize + 0.5/0.5 "
                        "normalize).")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Run the evaluation; returns the ConfusionMatrix and the softmax
    probabilities of the real (unpadded) rows, in data order."""
    args = parse_args(argv)
    if args.plot:
        # refused before any work: the heatmap is drawn after the evaluation
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--plot needs matplotlib, which is not "
                             "installed")
    import numpy as np
    import torch

    from medmamba_tpu_torch.data.datasets import open_dataset
    from medmamba_tpu_torch.data.loader import BatchLoader
    from medmamba_tpu_torch.eval.metrics import ConfusionMatrix
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.train.trainer import forward_fn
    from medmamba_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ds, _ = open_dataset(args.data_dir, args.split, load_size=args.image_size)
    state_dict, meta = restore_params(args.checkpoint_path)
    num_classes = (args.num_classes or meta.get("num_classes")
                   or ds.get_num_classes())
    class_indices = meta.get("class_indices") or ds.get_class_to_idx()
    labels = [str(k) for k in class_indices]

    model = create_model(args.medmb_size, num_classes, device=device)
    model.load_state_dict(state_dict, strict=True)
    # on the card one CUDA graph serves the split: the loader pads the final
    # batch to the full batch
    forward = forward_fn(model, device, image_size=args.image_size,
                         imagenet_preproc=args.imagenet_preproc)

    cm = ConfusionMatrix(num_classes, labels=labels)
    loader = BatchLoader(ds, args.batch_size, shuffle=False)
    kept = []
    for images, trues in loader.epoch(0):
        probs = forward(torch.from_numpy(images))[0].cpu().numpy()
        # the loader pads the final partial batch with label -1: padded
        # rows stay out of the metrics
        valid = trues >= 0
        cm.update(probs.argmax(1)[valid], trues[valid], probs[valid])
        kept.append(probs[valid])

    print(cm.summary())
    if args.plot:
        cm.plot(args.plot)
        print(f"confusion-matrix heatmap saved to {args.plot}")
    return cm, np.concatenate(kept, axis=0)


if __name__ == "__main__":
    main()
