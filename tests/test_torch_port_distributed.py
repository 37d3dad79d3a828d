"""The port's data-parallel training against one process and against the
JAX package's step on its mesh, on the CPU.

Two gloo ranks (``torch_port_ranks.spawn``, a ``file://`` rendezvous in the
test's directory) each step on their half of a global batch; the tiny VSSM
of ``tests/test_sharding.py`` (depths (1, 1), dims (8, 16), d_state 4) at
16^2. The step must compute what one process computes on the whole batch:
the loss within 1e-6 relative, the gradients AdamW is given and the
BatchNorm running statistics within 1e-5 of their scale (float32 sums in
another order; the statistics' scale is the largest statistic, since a
running mean behind a convolution of a 1x1 map is zero in exact
arithmetic; a gradient that is, as a convolution bias's in front of a
BatchNorm, is held to 1e-5 of 1e-3 of the largest gradient, as
chip_smoke's phase 9 holds gradients), with augmentation and DropPath on,
on a full batch of 8 and on 5 real rows padded to 8 (4 valid rows on rank
0, 1 on rank 1). A
per-rank mean with per-rank statistics, what ``DistributedDataParallel``
computes, is shown to miss the padded case by far more. Against the JAX
step on the 8-device virtual mesh (``augment=False``, drop path 0, weights
through ``utils/convert.py``) the tolerances are the JAX test's own
(``test_sharding.py:32-56``): loss 1e-4 relative, parameters after AdamW
2.5e-3 absolute (a near-zero first-step gradient may flip its update's
sign, a change of up to 2 lr).
"""
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from medmamba_tpu.models.vssm import VSSM as JaxVSSM
from medmamba_tpu.parallel import mesh as jax_mesh
from medmamba_tpu.train.trainer import init_state
from medmamba_tpu.train.trainer import make_optimizer as jax_optimizer
from medmamba_tpu.train.trainer import train_step as jax_train_step
from medmamba_tpu_torch.models.vssm import VSSM, MaskedBatchNorm
from medmamba_tpu_torch.parallel.mesh import active_mesh
from medmamba_tpu_torch.train import trainer
from medmamba_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

TINY = dict(num_classes=3, depths=(1, 1), dims=(8, 16), d_state=4)
SIZE = 16


def _batch(seed, real=8, b=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (b,)).astype(np.int64)
    labels[real:] = -1
    return torch.from_numpy(images), torch.from_numpy(labels)


def _one_process(weights, images, labels, *, augment, seed, **model_kw):
    model = VSSM(**TINY, **model_kw)
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in model.named_parameters()}))
    loss = trainer.train_step(model, opt, images, labels,
                              generator=torch.Generator().manual_seed(seed),
                              augment=augment, image_size=SIZE)
    return dict(loss=loss, grads=grads, state=model.state_dict())


def _rel(got, want, floor: float = 1e-30) -> float:
    scale = max(float(want.abs().max()), floor)
    return float((got - want).abs().max()) / scale


def _bn_stats(state):
    return {k: v for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("real", [8, 5])
def test_two_ranks_step_as_one_process(real, tmp_path):
    assert active_mesh() is None
    weights = VSSM(**TINY, drop_path_rate=0.5,
                   generator=torch.Generator().manual_seed(3)).state_dict()
    images, labels = _batch(real, real=real)
    kw = dict(augment=True, seed=11)
    want = _one_process(weights, images, labels, drop_path_rate=0.5, **kw)
    got = ranks.spawn(ranks.train_step, 2, tmp_path,
                      dict(TINY, drop_path_rate=0.5), weights, images,
                      labels, kw["augment"], kw["seed"], SIZE)
    floor = 1e-3 * max(float(w.abs().max()) for w in want["grads"].values())
    stats = _bn_stats(want["state"])
    stat_scale = max(float(w.abs().max()) for w in stats.values())
    for g in got:
        assert abs(g["loss"].item() - want["loss"].item()) \
            <= 1e-6 * abs(want["loss"].item())
        for name, w in want["grads"].items():
            assert _rel(g["grads"][name], w, floor) <= 1e-5, name
        for name, w in stats.items():
            assert float((g["state"][name] - w).abs().max()) \
                <= 1e-5 * stat_scale, name
        assert g["state"]["layers.0.blocks.0.conv33conv33conv11.0."
                          "num_batches_tracked"] == 1
    # the ranks applied the same update
    for name, w in got[0]["state"].items():
        torch.testing.assert_close(got[1]["state"][name], w, rtol=0, atol=0)


def test_per_rank_means_miss_the_padded_batch():
    """What ``DistributedDataParallel`` computes on the 5-of-8 batch (each
    rank's mean loss over its own valid rows with its own BatchNorm
    statistics, averaged over ranks; the same draws) is far from the global
    step's loss, so the test above can tell them apart."""
    weights = VSSM(**TINY, drop_path_rate=0.5,
                   generator=torch.Generator().manual_seed(3)).state_dict()
    images, labels = _batch(5, real=5)
    want = _one_process(weights, images, labels, augment=True, seed=11,
                        drop_path_rate=0.5)["loss"].item()
    per_rank = []
    for r in range(2):
        model = VSSM(**TINY, drop_path_rate=0.5).train()
        model.load_state_dict(weights)
        gen = torch.Generator().manual_seed(11)
        im, lb = images[4 * r:4 * r + 4], labels[4 * r:4 * r + 4]
        rows = (4 * r, 8)
        x = trainer.preprocess(im, size=SIZE, augment=True, generator=gen,
                               rows=rows)
        with torch.no_grad():
            per_rank.append(trainer.cross_entropy(
                model(x, lb >= 0, generator=gen, rows=rows), lb).item())
    ddp = sum(per_rank) / 2
    assert abs(ddp - want) > 1e3 * 1e-6 * abs(want), (ddp, want)


def test_eval_counts_are_summed_over_ranks(tmp_path):
    weights = VSSM(**TINY).state_dict()
    images, labels = _batch(1, real=5)
    model = VSSM(**TINY)
    model.load_state_dict(weights)
    want, logits = trainer.eval_step(model, images, labels, image_size=SIZE)
    got = ranks.spawn(ranks.eval_step, 2, tmp_path, TINY, weights, images,
                      labels, SIZE)
    assert [g["correct"].item() for g in got] == [want.item()] * 2
    torch.testing.assert_close(torch.cat([g["logits"] for g in got]),
                               logits, rtol=1e-5, atol=1e-6)


def test_a_parameter_without_a_gradient_stays_as_in_one_process(tmp_path):
    """Two ranks sum only the gradients the backward made: a parameter that
    no loss reaches keeps no gradient, gets no AdamW state and keeps its
    value (no weight decay), as in one process."""
    weights = VSSM(**TINY).state_dict()
    images, labels = _batch(2)
    got = ranks.spawn(ranks.unused_parameter_step, 2, tmp_path, TINY,
                      weights, images, labels)
    for g in got:
        assert not g["has_grad"] and not g["has_state"]
        assert torch.equal(g["unused"], torch.ones(3))


def test_two_ranks_step_matches_the_jax_step_on_its_mesh(tmp_path):
    model = JaxVSSM(**TINY, drop_path_rate=0.0, scan_impl="seq")
    state = init_state(model, jax.random.key(0),
                       jax_optimizer(1e-3, npz_mode=True),
                       input_shape=(1, SIZE, SIZE, 3))
    weights = state_dict_from_jax({"params": state.params,
                                   "batch_stats": state.batch_stats})
    images, labels = _batch(0)
    mesh = jax_mesh.make_mesh()
    try:
        si, sl = jax_mesh.shard_batch(mesh, images.numpy(), labels.numpy())
        new, loss = jax_train_step(jax_mesh.replicate_state(state, mesh), si,
                                   sl, jax.random.key(1), augment=False,
                                   image_size=SIZE)
        want = state_dict_from_jax({"params": new.params,
                                    "batch_stats": new.batch_stats})
    finally:
        jax_mesh.set_active_mesh(None)
    got = ranks.spawn(ranks.train_step, 2, tmp_path,
                      dict(TINY, drop_path_rate=0.0), weights, images,
                      labels, False, 0, SIZE)
    for g in got:
        np.testing.assert_allclose(g["loss"].item(), float(loss), rtol=1e-4)
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(g["state"][name].numpy(), w.numpy(),
                                       rtol=0, atol=2.5e-3, err_msg=name)


def _write_npz(root):
    rng = np.random.default_rng(0)
    for split, n in (("train", 7), ("val", 4)):
        np.save(os.path.join(root, f"{split}_images.npy"),
                rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8))
        np.save(os.path.join(root, f"{split}_labels.npy"),
                (np.arange(n) % 3).reshape(n, 1).astype(np.int64))


def test_train_cli_under_two_ranks_as_one_process(tmp_path):
    """``cli.train --device cpu`` (medmamba_t at 32^2; 7 images at global
    batch 8: one step, 4 valid rows on rank 0 and 3 on rank 1) in two ranks
    against one process: rank 0 alone writes the same files; the loss
    agrees to 1e-5 relative, and in the last ``.pth`` the BatchNorm
    statistics to 1e-5 of the largest statistic and the parameters within
    2 lr, the most two AdamW steps can part by. The gradients are held by
    the step tests above, not here: at 32^2 medmamba_t's last stage takes
    BatchNorm statistics of a 1x1 map over 7 rows, where E[x^2] - E[x]^2
    cancels, and one process whose BatchNorm sums are only taken in the
    ranks' order (two halves, then added) moves some last-stage gradients
    by 1.2e-2 of their scale on these inputs. A second step is not
    compared for the same reason."""
    from medmamba_tpu_torch.cli import train as train_cli

    data = str(tmp_path / "d")
    os.makedirs(data)
    _write_npz(data)

    def argv(run):
        return ["--train_dir", data, "--val_dir", data, "--batch_size", "8",
                "--epochs", "1", "--image_size", "32", "--augmentation",
                "--device", "cpu", "--save_dir", str(tmp_path / run),
                "--log_every", "0"]
    want = train_cli.main(argv("one"))
    got = ranks.spawn(ranks.train_cli, 2, tmp_path, argv("two"))
    assert [g["writes"] for g in got] == [3, 0]
    assert sorted(os.listdir(tmp_path / "two")) == sorted(
        os.listdir(tmp_path / "one"))
    steps = torch.tensor(want["step_losses"], dtype=torch.float64)
    assert len(steps) == 1
    for g in got:
        assert _rel(g["step_losses"], steps) <= 1e-5
    a, b = (torch.load(p, weights_only=True)
            for p in (want["last_path"], got[0]["last_path"]))
    assert a["model_state_dict"].keys() == b["model_state_dict"].keys()
    stats = _bn_stats(a["model_state_dict"])
    stat_scale = max(float(w.abs().max()) for w in stats.values())
    for name, w in a["model_state_dict"].items():
        v = b["model_state_dict"][name]
        if name in stats:
            assert float((v - w).abs().max()) <= 1e-5 * stat_scale, name
        else:
            torch.testing.assert_close(v, w, rtol=0, atol=2e-3)


def test_masked_batch_norm_runs_as_before_without_a_mesh():
    """No mesh, no collective: the train-mode statistics are the local
    batch's (the path the single-process tests hold to the JAX module)."""
    bn = MaskedBatchNorm(4).train()
    x = torch.randn(6, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([True, True, False, True, False, True])
    bn(x, mask)
    xs = x[mask]
    mean = xs.mean((0, 2, 3))
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
