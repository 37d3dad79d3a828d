"""Fetal-Planes-DB preparation: a standard-library copy of
``medmamba_tpu/utils/setup_fetal.py`` for the PyTorch port.

Matches ``Patient<id>_<Plane>_...`` filenames and moves images into per-plane
class folders.

Usage: python -m medmamba_tpu_torch.utils.setup_fetal --root DIR
"""
from __future__ import annotations

import argparse
import os
import re
import shutil

PLANE_RE = re.compile(r"Patient\d+_(Plane\d+)_.*", re.IGNORECASE)


def setup_fetal(root: str, images_subdir: str = "Images",
                out_subdir: str = "classified"):
    img_dir = os.path.join(root, images_subdir)
    out_dir = os.path.join(root, out_subdir)
    moved = 0
    for fname in sorted(os.listdir(img_dir)):
        m = PLANE_RE.match(fname)
        if not m:
            continue
        dst = os.path.join(out_dir, m.group(1))
        os.makedirs(dst, exist_ok=True)
        shutil.move(os.path.join(img_dir, fname), os.path.join(dst, fname))
        moved += 1
    print(f"moved {moved} images into {out_dir}")
    return out_dir


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--images_subdir", default="Images")
    args = p.parse_args()
    setup_fetal(args.root, args.images_subdir)
