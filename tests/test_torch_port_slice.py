"""The serving slice end to end, the port against the JAX package, on the CPU.

The same uint8 batch goes through the JAX ``preprocess`` + ``VSSM.apply`` +
softmax and through the port's; and the port's evaluate CLI runs on a tiny
NPZ split and a ``.pth`` in the reference schema.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from medmamba_tpu.data.transforms import preprocess as jax_preprocess
from medmamba_tpu.models import vssm as jv
from medmamba_tpu_torch.cli import evaluate
from medmamba_tpu_torch.data.transforms import preprocess
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.models.registry import create_model
from medmamba_tpu_torch.train.checkpoint import restore_params
from medmamba_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_model import _init

TOL = dict(rtol=1e-4, atol=1e-4)


def _images(seed, n, size):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("src", [28, 48, 32])
def test_preprocess_matches_jax(src):
    """28 -> 32 upsamples, 48 -> 32 downsamples (jax.image.resize
    antialiases there), 32 -> 32 only normalises."""
    imgs = _images(0, 3, src)
    want = np.asarray(jax_preprocess(jax.random.key(0), jnp.asarray(imgs),
                                     size=32, augment=False))
    got = preprocess(torch.from_numpy(imgs), size=32)
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src", [28, 48])
def test_slice_probabilities_match_jax(src):
    imgs = _images(1, 2, src)
    jm = jv.VSSM(num_classes=4, depths=(1, 1), dims=(16, 32), scan_impl="seq")
    variables = _init(jm, np.zeros((2, 32, 32, 3), np.float32), 1, True)
    want = np.asarray(jax.nn.softmax(jm.apply(
        variables, jax_preprocess(jax.random.key(0), jnp.asarray(imgs),
                                  size=32, augment=False), True), -1))
    tm = tv.VSSM(num_classes=4, depths=(1, 1), dims=(16, 32)).eval()
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = torch.softmax(tm(preprocess(torch.from_numpy(imgs), size=32)),
                            -1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _write_split(root, n=7, size=28, classes=3, seed=2):
    rng = np.random.default_rng(seed)
    imgs = _images(seed, n, size)
    labels = rng.integers(0, classes, (n, 1)).astype(np.int64)
    labels[:classes, 0] = np.arange(classes)     # every class present
    np.save(os.path.join(root, "test_images.npy"), imgs)
    np.save(os.path.join(root, "test_labels.npy"), labels)
    return imgs, labels[:, 0]


def _write_pth(path, num_classes, seed=0):
    model = create_model("T", num_classes, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    torch.save({"model_state_dict": model.state_dict(), "epoch": 3,
                "best_acc": 0.5, "num_classes": num_classes,
                "class_indices": {str(i): f"c{i}" for i in range(num_classes)}},
               path)
    return model.eval()


@pytest.mark.parametrize("imagenet", [False, True])
def test_evaluate_cli_end_to_end(tmp_path, imagenet):
    """7 images at batch 4: the second batch carries one padded row, which
    stays out of the matrix. The CLI's probabilities equal the model's own
    forward on the same preprocessing; with --imagenet_preproc that is
    jax.image.resize to 256, the centre crop and ImageNet normalisation."""
    imgs, labels = _write_split(str(tmp_path))
    pth = str(tmp_path / "w.pth")
    model = _write_pth(pth, 3)
    argv = ["--checkpoint_path", pth, "--data_dir", str(tmp_path),
            "--batch_size", "4", "--image_size", "32", "--device", "cpu"]
    cm, probs = evaluate.main(argv + (["--imagenet_preproc"] if imagenet
                                      else []))
    assert cm.matrix.sum() == len(imgs) == len(probs)
    assert cm.labels == ["0", "1", "2"]
    np.testing.assert_array_equal(cm.matrix.sum(0),
                                  np.bincount(labels, minlength=3))
    if imagenet:
        x = jax.image.resize(jnp.asarray(imgs, jnp.float32), (7, 256, 256, 3),
                             "bilinear")[:, 112:144, 112:144]
        x = (x / 255.0 - jnp.asarray([0.485, 0.456, 0.406])) \
            / jnp.asarray([0.229, 0.224, 0.225])
        x = torch.from_numpy(np.array(x))
    else:
        x = preprocess(torch.from_numpy(imgs), size=32)
    with torch.no_grad():
        want = torch.softmax(model(x), -1).numpy()
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-5)


def test_evaluate_cli_defaults_to_cuda(tmp_path, monkeypatch):
    _write_split(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--checkpoint_path", str(tmp_path / "missing.pth"),
                       "--data_dir", str(tmp_path)])


def test_create_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("T", 3)


def test_restore_params_reads_payload_and_bare_state_dict(tmp_path):
    pth = str(tmp_path / "w.pth")
    model = _write_pth(pth, 2, seed=5)
    sd, meta = restore_params(pth)
    assert meta == {"epoch": 3, "best_acc": 0.5, "num_classes": 2,
                    "class_indices": {"0": "c0", "1": "c1"}}
    ref = model.state_dict()
    assert sd.keys() == ref.keys()
    assert all(torch.equal(sd[k], ref[k]) for k in sd)
    torch.save(ref, pth)
    sd2, meta2 = restore_params(pth)
    assert meta2 == {} and sd2.keys() == ref.keys()


def test_restore_params_refuses_orbax_directory(tmp_path):
    with pytest.raises(ValueError, match="medmamba_tpu.cli.convert"):
        restore_params(str(tmp_path))
