"""Export a ``.pth`` checkpoint as a serialized ``torch.export`` serving
artifact.

Counterpart of ``medmamba_tpu/cli/export.py``. Usage:

    python -m medmamba_tpu_torch.cli.export --checkpoint_path weights.pth \
        --out model.pt2 [--medmb_size T] [--num_classes N] [--image_size 224] \
        [--input_size S] [--batch poly|N] [--no_preprocess] [--device cuda]

The artifact holds the weights and (by default) the preprocessing: a
serving process feeds raw uint8 (B, H, W, 3) frames to
``medmamba_tpu_torch.utils.export.load_exported(blob).call`` and gets class
probabilities back, with no model code or checkpoint (``utils/export.py``
says what loading does need). ``--batch poly`` (the default) exports a
symbolic batch.

The JAX CLI's ``--platforms`` and ``--scan_impl`` choose between a portable
XLA scan and the TPU kernel; here the artifact always holds the scan op,
which runs K1 on the card, or K3 when ``MEDMAMBA_SCAN_KERNEL=hillis`` is set
while exporting, and the plain scan for ``--device cpu``. The artifact runs
on the device it was exported on: ``--device cuda`` (the default; raises
without a card) or ``cpu``.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a serving artifact "
                                            "(PyTorch port).")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="a .pth file in the reference schema, or a bare "
                        "state dict")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--medmb_size", type=str, default="T",
                   choices=["T", "S", "B", "Te"])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--input_size", type=int, default=None,
                   help="spatial size of the raw frames the artifact "
                        "accepts (fixed; the baked-in preprocess resizes to "
                        "--image_size). Default: image_size, i.e. callers "
                        "pre-resize.")
    p.add_argument("--batch", type=str, default="poly",
                   help="'poly' (symbolic batch) or a fixed int")
    p.add_argument("--no_preprocess", action="store_true", default=False,
                   help="artifact consumes preprocessed float32 instead of "
                        "raw uint8")
    p.add_argument("--scan_tau", type=str, default="16",
                   choices=["16", "32", "64", "128"],
                   help="Accepted for the JAX CLI's flag surface; does "
                        "nothing here (the scan is exact).")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu: where the artifact runs")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from medmamba_tpu_torch.models import registry
    from medmamba_tpu_torch.ops.selective_scan import _kernel_impl
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.utils.device import resolve_device
    from medmamba_tpu_torch.utils.export import export_forward

    device = resolve_device(args.device)
    state_dict, meta = restore_params(args.checkpoint_path)
    num_classes = args.num_classes or meta.get("num_classes")
    if not num_classes:
        raise SystemExit("--num_classes required (not in checkpoint meta)")
    model = registry.create_model(args.medmb_size, num_classes, device=device)
    model.load_state_dict(state_dict, strict=True)
    blob = export_forward(
        model, image_size=args.image_size,
        batch=None if args.batch == "poly" else int(args.batch),
        input_size=args.input_size, with_preprocess=not args.no_preprocess,
        device=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    kernel = ("plain scan" if device.type == "cpu"
              else {"ssd": "K1", "hillis": "K3"}[_kernel_impl()])
    print(f"exported {len(blob) / 1e6:.1f} MB serving artifact to {args.out} "
          f"(medmamba_{args.medmb_size.lower()}, "
          f"batch={'symbolic' if args.batch == 'poly' else args.batch}, "
          f"device={device}, scan kernel {kernel})")


if __name__ == "__main__":
    main()
