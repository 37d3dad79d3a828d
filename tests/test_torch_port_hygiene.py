"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, and its copies of the JAX package's host code behave the same."""
import os
import re
import subprocess
import sys

import numpy as np

import medmamba_tpu_torch
from medmamba_tpu.eval.metrics import ConfusionMatrix as JaxConfusionMatrix
from medmamba_tpu_torch.data.loader import BatchLoader
from medmamba_tpu_torch.eval.metrics import ConfusionMatrix

PKG = os.path.dirname(os.path.abspath(medmamba_tpu_torch.__file__))
REPO = os.path.dirname(PKG)
FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|flax|optax|orbax|medmamba_tpu(?!_torch))\b",
    re.MULTILINE)


def test_importing_the_port_loads_no_jax():
    """Also: importing the probes launches nothing and prints nothing (the
    TPU tools ran their probes at import)."""
    code = ("import sys, medmamba_tpu_torch, medmamba_tpu_torch.cli.evaluate\n"
            "import medmamba_tpu_torch.cli.train\n"
            "import medmamba_tpu_torch.train.trainer\n"
            "import medmamba_tpu_torch.ops.scan_hillis\n"
            "import medmamba_tpu_torch.cli.demo, medmamba_tpu_torch.cli.test\n"
            "import medmamba_tpu_torch.eval.gradcam\n"
            "import medmamba_tpu_torch.utils.png\n"
            "from medmamba_tpu_torch.tools import probe_vpu, probe_mosaic\n"
            "import medmamba_tpu_torch.tools.cam_agreement\n"
            "import medmamba_tpu_torch.cli.export\n"
            "import medmamba_tpu_torch.utils.export\n"
            "import medmamba_tpu_torch.ops.flops\n"
            "import medmamba_tpu_torch.tools.earlier_kernels\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'medmamba_tpu'))\n"
            "bad += [m.__name__ for m in (probe_vpu, probe_mosaic) "
            "if m.LAUNCHES]\n"
            "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout == "[]\n"


def test_sources_import_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        files +=[os.path.join(base, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            offenders += [f"{path}: {m.group(0).strip()}"
                          for m in FORBIDDEN.finditer(f.read())]
    assert len(files) > 15 and not offenders, offenders


def test_confusion_matrix_matches_jax_copy():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(4), size=40)
    trues = rng.integers(0, 4, 40)
    ours, theirs = ConfusionMatrix(4), JaxConfusionMatrix(4)
    for cm in (ours, theirs):
        cm.update(probs.argmax(1), trues, probs)
    np.testing.assert_array_equal(ours.matrix, theirs.matrix)
    assert ours.summary() == theirs.summary()
    assert ours.auc() == theirs.auc()


class _Data:
    def __init__(self, n):
        self.images = np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1)
        self.labels = np.arange(n) % 3

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        return self.images[idx], self.labels[idx]


def test_loader_pads_the_final_batch_with_label_minus_one():
    batches = list(BatchLoader(_Data(10), 4, shuffle=False).epoch(0))
    assert [b[0].shape[0] for b in batches] == [4, 4, 4]
    np.testing.assert_array_equal(batches[-1][1], [2, 0, -1, -1])
    np.testing.assert_array_equal(batches[-1][0].ravel(), [8, 9, 9, 9])
    seen = np.concatenate([b[0].ravel()[b[1] >= 0] for b in batches])
    np.testing.assert_array_equal(seen, np.arange(10))
