"""A run without a card, or in a checkout without the program, exits
non-zero and prints no result (CPU)."""
import os
import shutil
import subprocess
import sys
import time

import pytest

from port_bench.core import harness

ARGS = ["--workload", "t_train_bf16", "--seed", "2147483701", "--seconds",
        "1", "--trace", "0"]


def _run(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")


def test_no_card_exits_nonzero_without_a_result(no_card):
    p = _run(harness.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copytree(os.path.join(harness.ROOT, "port_bench"),
                    tmp_path / "port_bench")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(str(tmp_path), {})
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_a_reader_that_loads_jax_stops_the_result(tmp_path, monkeypatch,
                                                  capsys):
    """The look for JAX comes after the per-layer readers: a reader that
    loads it leaves the run without a result."""
    import torch
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "stub.py").write_text(
        "import jax\n\ndef read(ctx):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "reader_path",
                        lambda name, root=None: str(tmp_path / "stub.py"))
    monkeypatch.setattr(harness, "run_cell", lambda cell: harness.Outcome(
        {"setup_s": 1.0}, [("loss_gap", 0.0, 1.0)], 1, 0, {}, {}))
    saved = sys.modules.pop("jax", None)
    assert not harness.forbidden_modules()
    try:
        rc = harness.main(["--workload", "t_train_bf16", "--seed", "1",
                           "--seconds", "1", "--trace", "1"], time.time())
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
        if saved is not None:
            sys.modules["jax"] = saved
    out = capsys.readouterr()
    assert rc != 0
    assert "{" not in out.out
    assert "jax" in out.err
