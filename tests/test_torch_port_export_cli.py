"""The port's export CLI against the JAX package's, and the port's artifact
loaded in a process without JAX, on the CPU.

Each CLI reads its own checkpoint format of the same tiny-VSSM weights (an
Orbax directory, a ``.pth`` from the port's ``save_checkpoint``), with
``create_model`` patched to the tiny architecture on both sides as in
``tests/test_export.py``, and num_classes from the checkpoints' metadata.
Probabilities agree to rtol = atol = 1e-5 (see
``test_torch_port_export.py``); the artifact gives the same bits in a fresh
process as the live model.
"""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from medmamba_tpu.models import registry as jreg
from medmamba_tpu.utils import export as jexport
from medmamba_tpu_torch.cli import export as tcli
from medmamba_tpu_torch.data.transforms import preprocess
from medmamba_tpu_torch.models import registry as treg
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.train.checkpoint import save_checkpoint
from medmamba_tpu_torch.utils import export as texport
from test_torch_port_export import (  # noqa: F401
    TINY, TOL, _frames, _torch_call, tiny)
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """(directory, the port CLI's printed line): ``m.pt2`` from the port's
    CLI and ``m.shlo`` from the JAX CLI, both with a symbolic batch."""
    import optax
    from medmamba_tpu.cli.export import main as jax_main
    from medmamba_tpu.train import checkpoint as jckpt
    from medmamba_tpu.train.trainer import TrainState

    jm, variables, tm = tiny
    d = tmp_path_factory.mktemp("export_cli")
    tx = optax.sgd(0.1)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx,
                       apply_fn=jm.apply)
    jckpt.save_checkpoint(str(d / "ck"), state, epoch=1, best_acc=0.5,
                          num_classes=3,
                          class_indices={"a": 0, "b": 1, "c": 2})
    jckpt.wait_for_saves()
    pth = str(d / "w.pth")
    save_checkpoint(pth, tm, torch.optim.SGD(tm.parameters(), lr=0.1),
                    epoch=1, best_acc=0.5, num_classes=3,
                    class_indices={"a": 0, "b": 1, "c": 2})

    def create(size, num_classes, **kw):
        assert (size, num_classes) == ("T", 3)
        return tv.VSSM(**TINY)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreg, "create_model", lambda size, num_classes, **kw: jm)
        mp.setattr(treg, "create_model", create)
        jax_main(["--checkpoint_path", str(d / "ck"), "--out",
                  str(d / "m.shlo"), "--image_size", "32", "--platforms",
                  "cpu"])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tcli.main(["--checkpoint_path", pth, "--out", str(d / "m.pt2"),
                       "--image_size", "32", "--device", "cpu"])
    return d, out.getvalue().strip()


def test_cli_matches_jax_cli(artifacts):
    d, line = artifacts
    assert "batch=symbolic" in line and "scan kernel plain scan" in line
    ours = texport.load_exported((d / "m.pt2").read_bytes())
    theirs = jexport.load_exported((d / "m.shlo").read_bytes())
    for b in (1, 3):
        x = _frames(10 + b, b, 32)
        np.testing.assert_allclose(
            _torch_call(ours, x), np.asarray(theirs.call(jnp.asarray(x))),
            **TOL)


def test_cli_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--checkpoint_path", str(tmp_path / "missing.pth"),
                   "--out", str(tmp_path / "m.pt2")])


def test_artifact_loads_in_a_process_without_jax(tiny, artifacts):
    """The loader needs the port, not JAX or the JAX package; the
    artifact's probabilities are the live model's bits."""
    d = artifacts[0]
    x = _frames(20, 3, 32)
    np.save(d / "x.npy", x)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'medmamba_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from medmamba_tpu_torch.utils.export import load_exported\n"
        f"d = {str(d)!r}\n"
        "exp = load_exported(open(d + '/m.pt2', 'rb').read())\n"
        "p = exp.call(torch.from_numpy(np.load(d + '/x.npy')))\n"
        "np.save(d + '/p.npy', p.numpy())\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
    got = np.load(d / "p.npy")
    with torch.no_grad():
        live = torch.softmax(tiny[2](preprocess(torch.from_numpy(x),
                                                size=32)), -1).numpy()
    np.testing.assert_array_equal(got, live)
    theirs = jexport.load_exported((d / "m.shlo").read_bytes())
    np.testing.assert_allclose(got, np.asarray(theirs.call(jnp.asarray(x))),
                               **TOL)
