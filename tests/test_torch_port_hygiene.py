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
            "import medmamba_tpu_torch.tools.tp_timing\n"
            "import medmamba_tpu_torch.utils.graphs\n"
            "import medmamba_tpu_torch.cli.cam_backbones\n"
            "import medmamba_tpu_torch.models.vit\n"
            "import medmamba_tpu_torch.models.swin\n"
            "import medmamba_tpu_torch.models.mobilenet\n"
            "import medmamba_tpu_torch.models.decoder\n"
            "import medmamba_tpu_torch.utils.convert_backbones\n"
            "import medmamba_tpu_torch.parallel.mesh\n"
            "import medmamba_tpu_torch.ops.seq_parallel\n"
            "import medmamba_tpu_torch.utils.setup_pad\n"
            "import medmamba_tpu_torch.utils.setup_fetal\n"
            "import medmamba_tpu_torch.utils.split_data\n"
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


def test_package_data_ships_every_kernel_source_and_header():
    """An installed copy of the port builds its kernels from the files that
    ``pyproject.toml``'s package data lists: every source that
    ``ops/cuda_build.py`` compiles and every header it includes must match
    a pattern there (the headers ``csrc/*.cuh`` were missing)."""
    import fnmatch
    import tomllib

    from medmamba_tpu_torch.ops import cuda_build, rotate, scan_cuda, \
        scan_hillis
    from medmamba_tpu_torch.tools import probe_mosaic, probe_vpu

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "medmamba_tpu_torch"]
    sources = (scan_cuda.FWD_SOURCE, scan_cuda.BWD_SOURCE,
               scan_hillis.FWD_SOURCE, scan_hillis.BWD_SOURCE, rotate.SOURCE,
               probe_vpu.SOURCE, probe_mosaic.SOURCE)
    needed = {f"csrc/{name}" for src in sources
              for name in cuda_build.source_files(src)}
    needed |= {f"csrc/{name}" for name in os.listdir(cuda_build.CSRC)}
    assert any(n.endswith(".cuh") for n in needed)
    missing = sorted(n for n in needed
                     if not any(fnmatch.fnmatch(n, p) for p in patterns))
    assert not missing, missing
