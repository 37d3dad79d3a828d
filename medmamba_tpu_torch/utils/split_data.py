"""Train/val/test split of a class-folder tree: a standard-library copy of
``medmamba_tpu/utils/split_data.py`` for the PyTorch port.

The reference uses ``splitfolders.ratio(ratio=(0.6, 0.1, 0.3), seed=42)``;
this is a dependency-free reimplementation with the same semantics: a
per-class shuffled split into ``output/{train,val,test}/<class>/``.

Usage: python -m medmamba_tpu_torch.utils.split_data --input DIR --output DIR \
           [--ratio 0.6 0.1 0.3 --seed 42 --move]
"""
from __future__ import annotations

import argparse
import os
import random
import shutil


def split_data(input_dir: str, output_dir: str,
               ratio=(0.6, 0.1, 0.3), seed: int = 42, move: bool = False):
    if abs(sum(ratio) - 1.0) >= 1e-6:
        raise ValueError(f"the ratios {tuple(ratio)} do not sum to 1")
    rng = random.Random(seed)
    op = shutil.move if move else shutil.copy2
    counts = {"train": 0, "val": 0, "test": 0}
    for cls in sorted(os.listdir(input_dir)):
        cdir = os.path.join(input_dir, cls)
        if not os.path.isdir(cdir):
            continue
        files = sorted(os.listdir(cdir))
        rng.shuffle(files)
        n = len(files)
        n_train = int(ratio[0] * n)
        n_val = int(ratio[1] * n)
        splits = {"train": files[:n_train],
                  "val": files[n_train:n_train + n_val],
                  "test": files[n_train + n_val:]}
        for split, names in splits.items():
            dst = os.path.join(output_dir, split, cls)
            os.makedirs(dst, exist_ok=True)
            for nme in names:
                op(os.path.join(cdir, nme), os.path.join(dst, nme))
            counts[split] += len(names)
    print(f"split done: {counts}")
    return counts


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--ratio", type=float, nargs=3, default=[0.6, 0.1, 0.3])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--move", action="store_true")
    args = p.parse_args()
    split_data(args.input, args.output, tuple(args.ratio), args.seed, args.move)
