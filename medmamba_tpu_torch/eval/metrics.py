"""Confusion-matrix evaluation + the README metric columns (P/R/Spec/F1/Acc/AUC).

A copy of ``medmamba_tpu/eval/metrics.py`` for the PyTorch port.

Parity: the reference ``ConfusionMatrix`` class (ConfusionMatrix/main.py:14-77)
computes a KxK matrix[pred, true], overall accuracy and per-class
Precision/Recall(Sensitivity)/Specificity, and a matplotlib heatmap. Its README
table (README.md:28-45) additionally reports macro F1 and AUC; this module
computes all of them in one vectorized pass (no sklearn dependency). Unlike the
reference script (hardwired to MobileNetV2, ConfusionMatrix/main.py:100-104), the
CLI in ``medmamba_tpu_torch.cli.evaluate`` wires this to the MedMamba model.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    """KxK confusion matrix with matrix[pred, true] indexing (main.py:25-27)."""

    def __init__(self, num_classes: int, labels: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.labels = list(labels) if labels else [str(i) for i in range(num_classes)]
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)
        self._probs: List[np.ndarray] = []
        self._trues: List[np.ndarray] = []

    def update(self, preds: np.ndarray, trues: np.ndarray,
               probs: Optional[np.ndarray] = None) -> None:
        preds = np.asarray(preds).ravel()
        trues = np.asarray(trues).ravel()
        np.add.at(self.matrix, (preds, trues), 1)
        if probs is not None:
            self._probs.append(np.asarray(probs))
            self._trues.append(trues)

    # ---- metric computations -------------------------------------------------

    def accuracy(self) -> float:
        total = self.matrix.sum()
        return float(np.trace(self.matrix) / total) if total else 0.0

    def per_class(self) -> Dict[str, np.ndarray]:
        m = self.matrix.astype(np.float64)
        tp = np.diag(m)
        fp = m.sum(axis=1) - tp   # predicted as k but not k
        fn = m.sum(axis=0) - tp   # true k predicted other
        tn = m.sum() - tp - fp - fn
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
            recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
            specificity = np.where(tn + fp > 0, tn / (tn + fp), 0.0)
            f1 = np.where(precision + recall > 0,
                          2 * precision * recall / (precision + recall), 0.0)
        return {"precision": precision, "recall": recall,
                "specificity": specificity, "f1": f1}

    def auc(self) -> Optional[float]:
        """Macro one-vs-rest ROC AUC from collected softmax probabilities."""
        if not self._probs:
            return None
        probs = np.concatenate(self._probs, axis=0)
        trues = np.concatenate(self._trues, axis=0)
        aucs = []
        for k in range(self.num_classes):
            pos = trues == k
            if pos.all() or pos.sum() == 0:  # AUC undefined without both classes
                continue
            aucs.append(_binary_auc(probs[:, k], pos))
        return float(np.mean(aucs)) if aucs else None

    def summary(self) -> str:
        """Printable table: overall acc + per-class and macro metrics."""
        pc = self.per_class()
        lines = [f"the model accuracy is {self.accuracy():.4f}", ""]
        header = f"{'class':>12} {'Precision':>10} {'Sensitivity':>12} " \
                 f"{'Specificity':>12} {'F1':>8}"
        lines.append(header)
        for i, name in enumerate(self.labels):
            lines.append(f"{name:>12} {pc['precision'][i]:>10.3f} "
                         f"{pc['recall'][i]:>12.3f} {pc['specificity'][i]:>12.3f} "
                         f"{pc['f1'][i]:>8.3f}")
        lines.append("")
        macro = {k: float(v.mean()) for k, v in pc.items()}
        auc = self.auc()
        lines.append(
            f"{'macro':>12} {macro['precision']:>10.3f} {macro['recall']:>12.3f} "
            f"{macro['specificity']:>12.3f} {macro['f1']:>8.3f}"
            + (f"   AUC {auc:.3f}" if auc is not None else ""))
        return "\n".join(lines)

    def plot(self, save_path: Optional[str] = None):
        """Heatmap with count annotations (ConfusionMatrix/main.py:51-77)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 7))
        im = ax.imshow(self.matrix, cmap=plt.cm.Blues)
        ax.set_xticks(range(self.num_classes), self.labels, rotation=45)
        ax.set_yticks(range(self.num_classes), self.labels)
        ax.set_xlabel("True Labels")
        ax.set_ylabel("Predicted Labels")
        ax.set_title("Confusion matrix")
        fig.colorbar(im, ax=ax)
        thresh = self.matrix.max() / 2 if self.matrix.size else 0
        for x in range(self.num_classes):
            for y in range(self.num_classes):
                v = int(self.matrix[y, x])
                ax.text(x, y, v, va="center", ha="center",
                        color="white" if v > thresh else "black")
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=150)
            plt.close(fig)
            return save_path
        return fig


def _binary_auc(scores: np.ndarray, positives: np.ndarray) -> float:
    """ROC AUC via the Mann-Whitney U statistic (ties handled by mid-ranks)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    n = len(scores)
    i = 0
    r = 1.0
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (r + r + (j - i))
        r += j - i + 1
        i = j + 1
    n_pos = int(positives.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    u = ranks[positives].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))
