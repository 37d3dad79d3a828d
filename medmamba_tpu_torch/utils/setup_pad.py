"""PAD-UFES-20 dataset preparation: a standard-library copy of
``medmamba_tpu/utils/setup_pad.py`` for the PyTorch port.

Parses ``metadata.csv`` (columns: patient_id, lesion_id, diagnostic), matches
image filenames ``PAT_<patient>_<lesion>_<n>.png``, and moves each image into a
per-diagnosis class folder.

Usage: python -m medmamba_tpu_torch.utils.setup_pad --root DIR [--images_subdir images]
"""
from __future__ import annotations

import argparse
import csv
import os
import re
import shutil

PAT_RE = re.compile(r"PAT_(\d+)_(\d+)_\d+\.png", re.IGNORECASE)


def setup_pad(root: str, images_subdir: str = "images",
              csv_name: str = "metadata.csv", out_subdir: str = "classified"):
    meta = {}
    with open(os.path.join(root, csv_name)) as f:
        for row in csv.DictReader(f):
            key = (row["patient_id"].replace("PAT_", ""),
                   row["lesion_id"])
            meta[key] = row["diagnostic"]

    img_dir = os.path.join(root, images_subdir)
    out_dir = os.path.join(root, out_subdir)
    moved = 0
    for fname in sorted(os.listdir(img_dir)):
        m = PAT_RE.match(fname)
        if not m:
            continue
        diag = meta.get((m.group(1), m.group(2)))
        if diag is None:
            continue
        dst = os.path.join(out_dir, diag)
        os.makedirs(dst, exist_ok=True)
        shutil.move(os.path.join(img_dir, fname), os.path.join(dst, fname))
        moved += 1
    print(f"moved {moved} images into {out_dir}")
    return out_dir


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--images_subdir", default="images")
    p.add_argument("--csv_name", default="metadata.csv")
    args = p.parse_args()
    setup_pad(args.root, args.images_subdir, args.csv_name)
