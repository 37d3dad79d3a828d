"""Dataset backends: MedMNIST-style NPZ and class-folder image trees.

A copy of ``medmamba_tpu/data/datasets.py`` for the PyTorch port (which
imports nothing of the JAX package). Capability parity with the reference
data layer:
  * ``NpzDataset``  <-> reference ``datasets.py:7-54`` (reads ``{split}_images.npy``
    + ``{split}_labels.npy``, squeezes (N,1) labels, promotes grayscale to RGB,
    ``get_num_classes`` / ``get_class_to_idx``).
  * ``FolderDataset`` <-> torchvision ``ImageFolder`` as used in ``train.py:126-128``
    (sorted class subdirectories -> indices).

Unlike the reference (per-item PIL transforms in DataLoader workers), these classes
only *load and batch raw uint8 arrays*; all geometric/color preprocessing happens
on the device in ``medmamba_tpu_torch.data.transforms``, batched. NPZ mode
imports no PIL; folder mode imports it only for a file that neither the native
library nor ``utils/png.py`` decodes.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from medmamba_tpu_torch.utils import png

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tif", ".tiff", ".webp")


def is_npz_dir(root: str, split: str) -> bool:
    """NPZ-mode autodetection (train.py:68-69, :148-149)."""
    return (os.path.exists(os.path.join(root, f"{split}_images.npy"))
            and os.path.exists(os.path.join(root, f"{split}_labels.npy")))


class NpzDataset:
    """MedMNIST ``.npy`` pair loader (reference datasets.py:7-54)."""

    def __init__(self, root_dir: str, split: str = "train"):
        self.root_dir = root_dir
        self.split = split
        images = np.load(os.path.join(root_dir, f"{split}_images.npy"))
        labels = np.load(os.path.join(root_dir, f"{split}_labels.npy"))
        if labels.ndim == 2 and labels.shape[1] == 1:
            labels = labels.squeeze(1)
        self.labels = labels.astype(np.int64)
        if images.ndim == 3:  # (N, H, W) grayscale -> RGB promotion
            images = np.repeat(images[..., None], 3, axis=-1)
        elif images.ndim == 4 and images.shape[-1] == 1:
            images = np.repeat(images, 3, axis=-1)
        self.images = np.ascontiguousarray(images.astype(np.uint8))

    def __len__(self) -> int:
        return len(self.labels)

    def get_batch(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        from medmamba_tpu_torch.data import native
        imgs = native.gather_u8(self.images, idx)
        if imgs is None:
            imgs = self.images[idx]
        return imgs, self.labels[idx]

    def get_num_classes(self) -> int:
        return int(len(np.unique(self.labels)))

    def get_class_to_idx(self) -> Dict[str, int]:
        # Mirror the reference (datasets.py:52-54): classes are named by the
        # actual unique label values, which matters when labels are
        # non-contiguous (e.g. a subset split keeping original ids).
        return {f"class_{int(v)}": int(v) for v in np.unique(self.labels)}


class FolderDataset:
    """Class-folder image tree (torchvision ImageFolder semantics).

    Images are decoded lazily and resized to a common ``load_size`` at load
    time (decode cost is per-image anyway); augmentation still runs on-device.
    """

    def __init__(self, root: str, load_size: int = 224):
        self.root = root
        self.load_size = load_size
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"No class sub-directories under {root}")
        self.classes: List[str] = classes
        self.class_to_idx: Dict[str, int] = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for base, _, files in sorted(os.walk(cdir)):
                for f in sorted(files):
                    if f.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(base, f),
                                             self.class_to_idx[c]))
        self.labels = np.array([s[1] for s in self.samples], np.int64)

    def __len__(self) -> int:
        return len(self.samples)

    def _load_one(self, path: str) -> np.ndarray:
        """``Image.open(path).convert("RGB")`` resized to ``load_size`` with
        PIL's bilinear filter, as the JAX data layer loads a file: a PNG
        already at ``load_size`` decodes without PIL, any other file needs
        it."""
        with open(path, "rb") as f:
            data = f.read()
        try:
            return png.load_rgb(data, self.load_size)
        except ImportError as e:
            raise RuntimeError(
                f"{path}: only PNGs of {self.load_size}x{self.load_size} "
                "decode without PIL, which is not installed") from e

    def get_batch(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        from medmamba_tpu_torch.data import native
        paths = [self.samples[i][0] for i in idx]
        imgs = native.batch_decode_resize(paths, self.load_size)
        if imgs is None:  # no native library, or a file it did not decode
            imgs = np.stack([self._load_one(p) for p in paths])
        return imgs, self.labels[idx]

    def get_num_classes(self) -> int:
        return len(self.classes)

    def get_class_to_idx(self) -> Dict[str, int]:
        return dict(self.class_to_idx)


def open_dataset(root: str, split: str, load_size: int = 224):
    """Auto-select NPZ vs folder mode for ``root`` (train.py:68-86 behavior)."""
    if is_npz_dir(root, split):
        return NpzDataset(root, split), True
    return FolderDataset(root, load_size=load_size), False
