"""Class-folder trees without PIL, and ``--plot`` without matplotlib, on the
CPU.

The port's ``cli.evaluate`` and ``cli.train`` read a tree of PNGs written
at ``load_size`` (32, the size of ``test_torch_port_slice.py``) with
``sys.modules["PIL"]`` set to None: the native library decodes them where
it is built, ``utils/png.py`` where it returns None. The JAX package's
``cli.evaluate`` reads the same tree (with PIL) and the same weights, a
``.pth`` written from numpy-drawn JAX variables with ``utils/convert.py``;
both CLIs build the tiny model of ``test_torch_port_demo.py``
(``create_model`` monkeypatched on each side). Its confusion matrix must
equal the port's, and its probabilities agree to 1e-5.
"""
import os
import sys

import numpy as np
import pytest
import torch

import medmamba_tpu.eval.metrics as jmetrics
import medmamba_tpu.models.registry as jreg
import medmamba_tpu_torch.models.registry as treg
from medmamba_tpu.cli import evaluate as jevaluate
from medmamba_tpu.models import vssm as jv
from medmamba_tpu_torch.cli import evaluate
from medmamba_tpu_torch.cli import train as train_cli
from medmamba_tpu_torch.data import native
from medmamba_tpu_torch.data.datasets import FolderDataset
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.utils import png
from medmamba_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_model import _init
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

TINY = dict(depths=(1, 1), dims=(8, 16), d_state=4, drop_path_rate=0.0)
SIZE = 32
CLASSES = ("benign", "malignant", "normal")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three class folders of PNGs at SIZE, one of them RGBA."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    for k, name in enumerate(CLASSES):
        os.makedirs(root / name)
        for i in range(3):
            channels = 4 if (k, i) == (1, 2) else 3
            img = rng.integers(0, 256, (SIZE, SIZE, channels), np.uint8)
            (root / name / f"img_{i}.png").write_bytes(png.encode(img))
    return str(root)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    variables = _init(jv.VSSM(num_classes=3, **TINY, scan_impl="seq"), x, 7,
                      True)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    torch.save({"model_state_dict": state_dict_from_jax(variables),
                "num_classes": 3, "epoch": 0, "best_acc": 0.0,
                "class_indices": {c: i for i, c in enumerate(CLASSES)}},
               path)
    return path


@pytest.fixture
def tiny_models(monkeypatch):
    monkeypatch.setattr(jreg, "create_model", lambda size, num_classes, **kw:
                        jv.VSSM(num_classes=num_classes, **TINY,
                                scan_impl="seq"))
    monkeypatch.setattr(treg, "create_model",
                        lambda size, num_classes, device="cuda", **kw:
                        tv.VSSM(num_classes=num_classes, **TINY).to(device))


def _hide(monkeypatch, *modules):
    for name in modules:
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(params=["native", "png"])
def decoder(request, monkeypatch):
    """Which decoder reads the tree: the native library, or ``utils/png``
    where the native library returns None."""
    if request.param == "native":
        if not native.available():
            pytest.skip("the native IO library is not built here")
    else:
        monkeypatch.setattr(native, "batch_decode_resize",
                            lambda paths, size, **kw: None)
    return request.param


def _argv(tree, pth):
    return ["--checkpoint_path", pth, "--data_dir", tree, "--batch_size",
            "4", "--image_size", str(SIZE)]


def test_evaluate_reads_a_png_tree_without_pil(tree, pth, tiny_models,
                                               decoder, monkeypatch):
    made = []

    class Recording(jmetrics.ConfusionMatrix):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)
    monkeypatch.setattr(jmetrics, "ConfusionMatrix", Recording)
    jevaluate.main(_argv(tree, pth))
    want = made[0]

    with monkeypatch.context() as m:
        _hide(m, "PIL", "PIL.Image")
        cm, probs = evaluate.main(_argv(tree, pth) + ["--device", "cpu"])
    assert cm.matrix.sum() == 3 * len(CLASSES)
    np.testing.assert_array_equal(cm.matrix, want.matrix)
    np.testing.assert_allclose(probs, np.concatenate(want._probs), rtol=1e-5,
                               atol=1e-5)


def test_train_reads_a_png_tree_without_pil(tree, tiny_models, decoder,
                                            monkeypatch, tmp_path):
    _hide(monkeypatch, "PIL", "PIL.Image")
    run = str(tmp_path / "run")
    out = train_cli.main(["--train_dir", tree, "--val_dir", tree,
                          "--epochs", "1", "--batch_size", "4",
                          "--image_size", str(SIZE), "--device", "cpu",
                          "--save_dir", run, "--log_every", "0"])
    assert np.isfinite(out["train_loss"])
    assert os.path.exists(out["best_path"])
    assert os.path.exists(out["last_path"])


def test_a_file_that_needs_pil_names_itself(tmp_path, monkeypatch):
    """A PNG at another size than load_size needs PIL's resize."""
    os.makedirs(tmp_path / "a")
    path = tmp_path / "a" / "small.png"
    path.write_bytes(png.encode(np.zeros((16, 16, 3), np.uint8)))
    monkeypatch.setattr(native, "batch_decode_resize",
                        lambda paths, size, **kw: None)
    _hide(monkeypatch, "PIL", "PIL.Image")
    ds = FolderDataset(str(tmp_path), load_size=SIZE)
    with pytest.raises(RuntimeError, match="small.png"):
        ds.get_batch(np.array([0]))


def test_plot_is_refused_before_evaluating(tmp_path, monkeypatch):
    """Without matplotlib, --plot stops the CLI before it reads the
    checkpoint or the data (neither exists here)."""
    _hide(monkeypatch, "matplotlib")
    with pytest.raises(SystemExit, match="matplotlib"):
        evaluate.main(["--checkpoint_path", str(tmp_path / "missing.pth"),
                       "--data_dir", str(tmp_path / "missing"), "--plot",
                       str(tmp_path / "cm.png"), "--device", "cpu"])
