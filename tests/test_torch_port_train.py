"""The port's training slice against the JAX package's, on the CPU.

* The VSSM in train mode (masked BatchNorm statistics): loss, parameter
  gradients (carried through ``state_dict_from_jax``) and running statistics
  against ``jax.value_and_grad`` of the JAX model with ``scan_impl="seq"``,
  float32 to 1e-4. Drop path is 0 on both sides: the two frameworks' random
  bits cannot match.
* bfloat16 blocks: logits against the JAX bfloat16 model within 3e-2 of the
  logit scale (the two round to bfloat16 at the same layers but accumulate
  in other orders; 2^-8 relative per rounding over about ten layers).
* ``make_optimizer`` against optax's AdamW across a MultiStepLR milestone,
  1e-6; ``cross_entropy``; activation checkpointing; the train CLI end to
  end on a tiny NPZ split with ``--device cpu``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.models import vssm as jv
from medmamba_tpu.train.trainer import cross_entropy as jax_cross_entropy
from medmamba_tpu.train.trainer import make_optimizer as jax_make_optimizer
from medmamba_tpu_torch.cli import evaluate
from medmamba_tpu_torch.cli import train as train_cli
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.train import trainer
from medmamba_tpu_torch.train.checkpoint import restore_params
from medmamba_tpu_torch.utils.convert import (state_dict_from_jax,
                                              state_dict_to_jax)
from test_torch_port_model import _init
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

SMALL = dict(num_classes=4, depths=(1, 1), dims=(16, 32))
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(seed, b=3, size=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    labels = np.array([0, 2, -1][:b] + [1] * max(0, b - 3), np.int64)
    return x, labels


def _port(variables, **kw):
    model = tv.VSSM(**SMALL, drop_path_rate=0.0, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("size", [32, 24])
def test_train_mode_loss_grads_and_batch_stats_match_jax(size):
    """24^2: the stages run 6x6 -> 3x3 (an odd size the merge crops)."""
    x, labels = _batch(size, size=size)
    mask = labels >= 0
    jm = jv.VSSM(**SMALL, drop_path_rate=0.0, scan_impl="seq")
    variables = _init(jm, x, size, True)

    def loss_fn(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), False, jnp.asarray(mask),
                            mutable=["batch_stats"])
        return jax_cross_entropy(out, jnp.asarray(labels)), upd
    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    tm = _port(variables).train()
    got = trainer.cross_entropy(tm(torch.from_numpy(x),
                                   torch.from_numpy(mask)),
                                torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **TOL)
    want = state_dict_from_jax({"params": grads})
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), w.numpy(),
                                   err_msg=name, **TOL)
    stats = state_dict_to_jax(tm.state_dict())["batch_stats"]
    for path, w in jax.tree_util.tree_leaves_with_path(upd["batch_stats"]):
        g = stats
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_bf16_blocks_logits_match_jax():
    x, _ = _batch(3)
    jm = jv.VSSM(**SMALL, drop_path_rate=0.0, scan_impl="seq",
                 dtype=jnp.bfloat16)
    variables = _init(jm, x, 3, True)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, True))(
        variables, jnp.asarray(x)))
    tm = _port(variables, dtype=torch.bfloat16).eval()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 3e-2 * scale


def test_bf16_blocks_train_step_gives_float32_grads():
    x, labels = _batch(4)
    tm = tv.VSSM(**SMALL, drop_path_rate=0.0, dtype=torch.bfloat16).train()
    loss = trainer.cross_entropy(tm(torch.from_numpy(x)),
                                 torch.from_numpy(labels))
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("npz_mode", [True, False])
def test_optimizer_matches_optax_across_a_milestone(npz_mode):
    """Three steps with the milestone after the second (one step per
    epoch): the third update runs at lr * 0.1 in NPZ mode."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    schedule = [2] if npz_mode else []
    tx = jax_make_optimizer(1e-2, npz_mode, schedule, steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, sched = trainer.make_optimizer(tp.values(), 1e-2, npz_mode,
                                        schedule)
    assert (sched is None) == (not npz_mode)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        if sched is not None:
            sched.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6)


def test_cross_entropy_masks_padding_and_is_zero_when_all_masked():
    logits = np.random.default_rng(1).standard_normal((4, 5)).astype(
        np.float32)
    labels = np.array([3, -1, 0, -1])
    got = trainer.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    none = trainer.cross_entropy(torch.from_numpy(logits),
                                 torch.full((4,), -1))
    assert none.item() == 0.0


def test_checkpointed_blocks_give_the_same_gradients_and_stats():
    """use_checkpoint recomputes each block in the backward with the same
    DropPath keep mask and without a second BatchNorm statistics update."""
    x, labels = _batch(5)
    torch.manual_seed(0)
    runs = []
    for remat in (False, True):
        m = tv.VSSM(**SMALL, drop_path_rate=0.5, use_checkpoint=remat,
                    generator=torch.Generator().manual_seed(1)).train()
        loss = trainer.cross_entropy(
            m(torch.from_numpy(x), generator=torch.Generator().manual_seed(2)),
            torch.from_numpy(labels))
        loss.backward()
        runs.append((loss, {n: p.grad for n, p in m.named_parameters()},
                     m.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0.item() == l1.item()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7)
    for n in s0:
        torch.testing.assert_close(s1[n], s0[n], rtol=0, atol=0)
    assert s1["layers.0.blocks.0.conv33conv33conv11.0.num_batches_tracked"] \
        == 1


def test_drop_path_draws_only_from_the_given_generator():
    x, _ = _batch(6)
    m = tv.VSSM(**SMALL, drop_path_rate=0.5).train()
    with pytest.raises(ValueError, match="Generator"):
        m(torch.from_numpy(x))
    torch.manual_seed(0)
    a = m(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    torch.manual_seed(1)
    b = m(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _write_npz(root, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train", 6), ("val", 4)):
        np.save(os.path.join(root, f"{split}_images.npy"),
                rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8))
        np.save(os.path.join(root, f"{split}_labels.npy"),
                (np.arange(n) % 3).reshape(n, 1).astype(np.int64))


def test_train_cli_lifecycle_resume_and_evaluate(tmp_path, monkeypatch):
    """Two epochs whose validation accuracy rises: the epoch-2 best replaces
    the epoch-1 best, which is deleted only then; the last checkpoint and
    the class-index sidecar are written; --resume continues at epoch 3 from
    the last .pth; cli.evaluate serves the best one."""
    data = str(tmp_path / "d")
    os.makedirs(data)
    _write_npz(data)
    accs = iter([1, 2, 2])                 # correct rows per val pass

    def fake_eval(model, images, labels, *, image_size):
        _, logits = real_eval(model, images, labels, image_size=image_size)
        return torch.tensor(next(accs) if len(labels) == 6 else 0), logits
    real_eval = trainer.eval_step
    monkeypatch.setattr(trainer, "eval_step", fake_eval)
    run = str(tmp_path / "run")
    argv = ["--train_dir", data, "--val_dir", data, "--batch_size", "6",
            "--image_size", "32", "--augmentation", "--device", "cpu",
            "--save_dir", run, "--log_every", "0"]
    out = train_cli.main(argv + ["--epochs", "2"])
    best, last = out["best_path"], out["last_path"]
    assert out["best_acc"] == 0.5 and np.isfinite(out["train_loss"])
    assert sorted(os.listdir(run)) == ["Medmamba_epoch_2_best.pth",
                                       "Medmamba_epoch_2_last.pth",
                                       "class_indices.json"]
    assert best.endswith("epoch_2_best.pth")
    sd, meta = restore_params(best)
    assert meta["epoch"] == 2 and meta["num_classes"] == 3
    payload = torch.load(last, weights_only=True)
    assert set(payload) == {"epoch", "model_state_dict",
                            "optimizer_state_dict", "best_acc",
                            "num_classes", "class_indices"}

    out = train_cli.main(argv + ["--epochs", "3", "--resume", last])
    assert out["last_path"].endswith("epoch_3_last.pth")
    assert out["best_path"] is None and out["best_acc"] == 0.5
    assert "Medmamba_epoch_2_best.pth" in os.listdir(run)
    out = train_cli.main(argv + ["--epochs", "2", "--resume",
                                 out["last_path"]])
    assert out["last_path"] is None

    cm, probs = evaluate.main(["--checkpoint_path", best, "--data_dir", data,
                               "--split", "val", "--image_size", "32",
                               "--device", "cpu"])
    assert probs.shape == (4, 3) and cm.matrix.sum() == 4


def test_train_cli_defaults_to_cuda(tmp_path, monkeypatch):
    _write_npz(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--train_dir", str(tmp_path), "--val_dir",
                        str(tmp_path)])
