"""The compiled steps' host side, on the CPU (CUDA graphs themselves run on
the card: ``test_torch_port_cuda.py -k graph`` and ``chip_smoke.py`` phase
23).

* The step bodies a graph captures make no host sync and copy nothing from
  host memory after their first call: ``train_step`` (augmenting, with the
  capturable AdamW the card runs), ``eval_step``, ``predict`` and the
  Grad-CAM's body (at the default target with the class taken on the
  device, at two targets, with ``substitute``), under a dispatch mode that
  records every operator; the CAM body gives the eager ``grad_cam``'s
  bits.
* The tensor learning rate with ``MultiStepLR`` against the JAX package's
  ``train_step`` with optax's piecewise schedule
  (``medmamba_tpu/train/trainer.py:46-57``), on the tiny VSSM from one set
  of converted weights: losses and parameters to 1e-5.
* Checkpoints of the tensor-rate optimizer keep the reference schema and
  resume an eager AdamW to the same next step, and the reverse.
* ``utils/graphs.py``'s device-free parts: the cache key, the state guard,
  the launch counts a replay adds, the bound on a step's graphs (a fake
  capture), and the refusal of a CPU model by every compiled step, the
  graphed Grad-CAM and an artifact's graphs.
* ``cli.train`` logs each step's own loss when the step returns one
  buffer that every call overwrites, as a graph's loss is.
"""
import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from medmamba_tpu.models import vssm as jv
from medmamba_tpu.train import trainer as jax_trainer
from medmamba_tpu_torch.cli import train as train_cli
from medmamba_tpu_torch.data.transforms import preprocess
from medmamba_tpu_torch.eval import gradcam
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.ops import rotate, scan_cuda, scan_hillis
from medmamba_tpu_torch.train import checkpoint as ckpt
from medmamba_tpu_torch.train import trainer
from medmamba_tpu_torch.utils import graphs
from medmamba_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_model import _init
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

SMALL = dict(num_classes=4, depths=(1, 1), dims=(16, 32))
# operators that read a device value on the host, or whose output shape
# depends on one: each is a sync with the card
SYNCS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
         "aten.is_nonzero", "aten.equal"}


@pytest.fixture
def capturable_on_cpu(monkeypatch):
    """torch's capturable AdamW refuses CPU parameters only by a device
    list; widened here, with the port's, ``make_optimizer`` makes the CPU
    run the optimizer code of the card's captured step."""
    import torch.optim.adam as adam
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cpu", "cuda"])
    monkeypatch.setattr(trainer, "CAPTURABLE_DEVICES", ("cpu", "cuda"))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _uint8(seed, b=3, size=28):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, size, size, 3), dtype=np.uint8))


def _steps(model, opt, gen):
    """Each step on its own batch, made now, as a closure."""
    labels = torch.tensor([0, 3, -1])
    x1, x2, x3 = _uint8(1), _uint8(2), _uint8(3)
    return {
        "train_step": lambda: trainer.train_step(
            model, opt, x1, labels, generator=gen, augment=True,
            image_size=32),
        "eval_step": lambda: trainer.eval_step(model, x2, labels,
                                               image_size=32),
        "predict": lambda: trainer.predict(model, x3, image_size=32)}


@pytest.mark.parametrize("step", ["train_step", "eval_step", "predict"])
def test_step_bodies_make_no_host_sync(step, capturable_on_cpu):
    """The second call of each step (the first makes the optimizer's state
    and the resize matrices, as a graph's warm-up does) dispatches none of
    SYNCS. Drop path 0.5, so DropPath draws too."""
    model = tv.VSSM(**SMALL, drop_path_rate=0.5)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True, [1])
    assert opt.param_groups[0]["capturable"]
    fn = _steps(model, opt, torch.Generator().manual_seed(0))[step]
    fn()
    with _Ops() as ops:
        fn()
    assert "aten.addmm" in ops.names or "aten.mm" in ops.names
    assert not ops.names & SYNCS, ops.names & SYNCS


def test_steps_copy_nothing_from_host_memory_after_their_first_call(
        monkeypatch):
    """``torch.from_numpy`` is how host arrays reach a step; a graph's
    capture would refuse the copy that follows it (the parent's resize
    built its matrices in numpy at every call)."""
    model = tv.VSSM(**SMALL, drop_path_rate=0.5)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    fns = _steps(model, opt, torch.Generator().manual_seed(0))
    for fn in fns.values():
        fn()
    calls, real = [], torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy",
                        lambda a: calls.append(a.shape) or real(a))
    for fn in fns.values():
        fn()
    assert calls == []


# the CAM body's cases: (target paths, a class given, substitute sites)
CAM_CASES = {
    "default": (None, False, ()),
    "two_targets": (["layers_0.blocks_0.conv1x1", "layers_1.blocks_0.conv1x1"],
                    True, ()),
    "substitute": (["layers_0.blocks_0.conv1x1"], True,
                   ("layers_0.blocks_0.conv1x1", "layers_0.blocks_0")),
}


@pytest.mark.parametrize("case", sorted(CAM_CASES))
def test_cam_body_makes_no_host_sync_and_no_host_copy(case, monkeypatch):
    """The Grad-CAM's step body, inside the taps its host wrapper installs:
    the second call dispatches none of SYNCS and copies nothing from host
    memory (the first makes the resize matrices, as a graph's warm-up
    does), and its CAM is the eager ``grad_cam``'s bit for bit."""
    model = tv.VSSM(**SMALL).eval()
    x = preprocess(_uint8(4), size=32)
    paths, given, sites = CAM_CASES[case]
    paths = paths or [".".join(gradcam.default_target_path(model))]
    target = torch.tensor([1, 0, 3]) if given else None
    subs = gradcam.target_activations(model, x, sites)
    with gradcam._cam_setup(model, paths, sites, (32, 32)) as body:
        body(x, target, *subs)
        calls, real = [], torch.from_numpy
        monkeypatch.setattr(torch, "from_numpy",
                            lambda a: calls.append(a.shape) or real(a))
        with _Ops() as ops:
            cam, logits = body(x, target, *subs)
        monkeypatch.setattr(torch, "from_numpy", real)
    assert "aten.mm" in ops.names or "aten.addmm" in ops.names
    assert not ops.names & SYNCS, ops.names & SYNCS
    assert calls == []
    assert cam.shape == (3, 32, 32) and logits.shape == (3, 4)
    assert all(not m.taps for m in model.modules() if hasattr(m, "taps"))
    want = gradcam.grad_cam(model, x, target_class=target,
                            target_paths=paths,
                            substitute=dict(zip(sites, subs)))
    np.testing.assert_array_equal(cam.numpy(), want)


def _jax_state(variables, tx):
    jm = jv.VSSM(**SMALL, drop_path_rate=0.0, scan_impl="seq")
    return jax_trainer.TrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=tx)


@pytest.mark.parametrize("capturable", [False, True])
def test_tensor_lr_schedule_matches_jax_train_step(capturable, request):
    """2 steps an epoch, the milestone at epoch 1, 4 steps: steps 3 and 4
    run at a tenth of the rate on both sides. capturable: the optimizer
    code of the card's captured step (True) or of the CPU's (False). Every
    parameter and statistic at 1e-5 but the conv biases in front of a
    BatchNorm and that BatchNorm's running mean (BIAS_BEFORE_BN)."""
    if capturable:
        request.getfixturevalue("capturable_on_cpu")
    lr, steps_per_epoch, milestones = 1e-3, 2, [1]
    rng = np.random.default_rng(7)
    batches = [(rng.integers(0, 256, (3, 28, 28, 3), dtype=np.uint8),
                np.array([0, 3, -1]) if k % 2 else np.array([1, 2, 2]))
               for k in range(4)]
    jm = jv.VSSM(**SMALL, drop_path_rate=0.0, scan_impl="seq")
    variables = _init(jm, np.zeros((3, 32, 32, 3), np.float32), 11, False)
    tx = jax_trainer.make_optimizer(lr, True, milestones,
                                    steps_per_epoch=steps_per_epoch)
    state = _jax_state(variables, tx)

    model = tv.VSSM(**SMALL, drop_path_rate=0.0)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt, sched = trainer.make_optimizer(model.parameters(), lr, True,
                                        milestones)
    assert opt.param_groups[0]["capturable"] == capturable
    gen = torch.Generator().manual_seed(0)
    for k, (images, labels) in enumerate(batches):
        state, want = jax_trainer.train_step(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(0), augment=False, image_size=32)
        got = trainer.train_step(model, opt, torch.from_numpy(images),
                                 torch.from_numpy(labels), generator=gen,
                                 image_size=32)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {k + 1}")
        if (k + 1) % steps_per_epoch == 0:
            sched.step()
    assert float(opt.param_groups[0]["lr"]) == pytest.approx(lr * 0.1)
    want = state_dict_from_jax({"params": state.params,
                                "batch_stats": state.batch_stats})
    got = model.state_dict()
    held = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert got[name].item() == 4      # the JAX model counts none
        elif not BIAS_BEFORE_BN.search(name):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            held += 1
    assert held == len(want) - 6 - 8


# the conv biases in front of a BatchNorm: their gradient is zero in exact
# arithmetic, and AdamW scales either package's rounding noise there into
# steps of the learning rate's size, so they are not held to 1e-5, nor is
# the running mean of the BatchNorm after each, which adds the bias in
BIAS_BEFORE_BN = re.compile(r"conv33conv33conv11\.([14]\.bias|[25]\."
                            r"running_mean)$")


def _eager_adamw(params, lr):
    """The AdamW the port made before its rate was a tensor."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    return opt, torch.optim.lr_scheduler.MultiStepLR(opt, [1], gamma=0.1)


@pytest.mark.parametrize("saved_by", ["tensor_lr", "eager"])
def test_checkpoint_resumes_across_optimizer_kinds(saved_by, tmp_path,
                                                   capturable_on_cpu):
    """Two steps and a milestone, saved; the other kind of optimizer,
    resumed from the file, takes the third step as the saver does."""
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal((4, 3)).astype(np.float32)
             for _ in range(3)]

    def make(kind, w):
        model = torch.nn.Linear(3, 4, bias=False)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(w))
        if kind == "tensor_lr":
            return (model, *trainer.make_optimizer(
                model.parameters(), 1e-2, True, [1]))
        return (model, *_eager_adamw(model.parameters(), 1e-2))

    def step(model, opt, g):
        model.weight.grad = torch.from_numpy(g)
        opt.step()

    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    model, opt, sched = make(saved_by, w0)
    for g in grads[:2]:
        step(model, opt, g)
    sched.step()
    path = str(tmp_path / "run.pth")
    ckpt.save_checkpoint(path, model, opt, epoch=1, best_acc=0.5,
                         num_classes=4, class_indices={"a": 0})
    payload = torch.load(path, weights_only=True)
    group = payload["optimizer_state_dict"]["param_groups"][0]
    assert type(group["lr"]) is float and group["lr"] == pytest.approx(1e-3)
    assert type(group["initial_lr"]) is float and not group["capturable"]
    st = payload["optimizer_state_dict"]["state"][0]
    assert st["step"].device.type == "cpu" and st["step"].dtype == \
        torch.float32 and st["step"].item() == 2.0
    assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
    step(model, opt, grads[2])

    other = "eager" if saved_by == "tensor_lr" else "tensor_lr"
    resumed, ropt, _ = make(other, w0)
    lr_tensor = ropt.param_groups[0]["lr"]
    ckpt.restore_checkpoint(path, resumed, ropt)
    if other == "tensor_lr":
        assert ropt.param_groups[0]["lr"] is lr_tensor
        assert ropt.param_groups[0]["capturable"]
    assert float(ropt.param_groups[0]["lr"]) == pytest.approx(1e-3)
    step(resumed, ropt, grads[2])
    np.testing.assert_allclose(resumed.weight.detach().numpy(),
                               model.weight.detach().numpy(), rtol=1e-6,
                               atol=1e-7)


def test_cache_key_changes_with_shape_mode_and_scan_variables(monkeypatch):
    x = torch.zeros(2, 28, 28, 3, dtype=torch.uint8)
    y = torch.zeros(2, dtype=torch.long)
    monkeypatch.delenv("MEDMAMBA_SCAN_KERNEL", raising=False)
    monkeypatch.delenv("MEDMAMBA_SCAN_COMPUTE", raising=False)
    base = graphs.cache_key("train_step", (x, y),
                            dict(augment=True, image_size=32))
    assert base[-1] == ("ssd", "float32")
    keys = {
        graphs.cache_key("train_step", (x[:1], y[:1]),
                         dict(augment=True, image_size=32)),
        graphs.cache_key("train_step", (x.float(), y),
                         dict(augment=True, image_size=32)),
        graphs.cache_key("train_step", (x, y),
                         dict(augment=False, image_size=32)),
        graphs.cache_key("train_step", (x, y),
                         dict(augment=True, image_size=64)),
        graphs.cache_key("eval_step", (x, y), dict(image_size=32))}
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "hillis")
    keys.add(graphs.cache_key("train_step", (x, y),
                              dict(augment=True, image_size=32)))
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", "bfloat16")
    keys.add(graphs.cache_key("train_step", (x, y),
                              dict(augment=True, image_size=32)))
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "ssd")
    keys.add(graphs.cache_key("train_step", (x, y),
                              dict(augment=True, image_size=32)))
    assert base not in keys and len(keys) == 8
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", "float32")
    assert graphs.cache_key("train_step", (x.clone(), y),
                            dict(image_size=32, augment=True)) == base
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "other")
    with pytest.raises(ValueError, match="MEDMAMBA_SCAN_KERNEL"):
        graphs.cache_key("train_step", (x, y), {})


def test_state_guard_trips_on_replaced_tensors_only():
    model = tv.VSSM(**SMALL)
    opt, sched = trainer.make_optimizer(model.parameters(), 1e-3, True, [1])
    gen = torch.Generator().manual_seed(0)
    _steps(model, opt, gen)["train_step"]()
    guard = graphs.StateGuard(model, opt)
    # in place: a model's load_state_dict, the scheduler's milestone, a step
    model.load_state_dict(copy.deepcopy(model.state_dict()))
    sched.step()
    _steps(model, opt, gen)["train_step"]()
    guard.check()
    assert opt.param_groups[0]["lr"].item() == pytest.approx(1e-4)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    with pytest.raises(RuntimeError, match="optimizer state"):
        guard.check()
    guard = graphs.StateGuard(model, opt)
    p = next(model.parameters())
    p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="parameter"):
        guard.check()
    guard = graphs.StateGuard(model, opt)
    model.layers[0].blocks[0].conv33conv33conv11[0].running_mean = \
        torch.zeros(8)
    with pytest.raises(RuntimeError, match="buffer"):
        guard.check()


def test_counts_of_a_capture_are_added_per_replay(monkeypatch):
    """``counted`` takes a call's launches out of the counters and returns
    them; ``add_counts`` adds them per replay."""
    for m, a in graphs.COUNTERS:
        monkeypatch.setattr(m, a, 7)

    def step():
        scan_cuda.LAUNCHES += 20
        scan_cuda.BWD_LAUNCHES += 20
        rotate.LAUNCHES += 1
        return "out"
    out, delta = graphs.counted(step)
    assert out == "out" and graphs.read_counts() == {
        k: 7 for k in graphs.read_counts()}
    assert delta == {"scan_cuda.LAUNCHES": 20, "scan_cuda.BWD_LAUNCHES": 20,
                     "scan_hillis.HILLIS_LAUNCHES": 0,
                     "scan_hillis.HILLIS_BWD_LAUNCHES": 0,
                     "rotate.LAUNCHES": 1}
    for _ in range(3):
        graphs.add_counts(delta)
    assert (scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES, rotate.LAUNCHES,
            scan_hillis.HILLIS_LAUNCHES) == (67, 67, 10, 7)


def test_compiled_steps_refuse_a_cpu_model():
    """No silent fallback: graphs are a CUDA feature, and a CPU model's
    step raises instead of running eagerly."""
    model = tv.VSSM(**SMALL)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    x, y = _uint8(0), torch.tensor([0, 1, 2])
    for call in (
            lambda: trainer.compile_forward(model)(x, image_size=32),
            lambda: trainer.compile_eval_step(model)(x, y, image_size=32),
            lambda: trainer.compile_train_step(
                model, opt, generator=torch.Generator())(x, y,
                                                         image_size=32)):
        with pytest.raises(RuntimeError, match="CUDA graphs need"):
            call()


class _FakeGraph:
    def __init__(self, key):
        self.key, self.freed = key, False

    def __call__(self, *inputs):
        return self.key

    def free(self):
        self.freed = True


def test_compiled_step_frees_its_least_recently_used_graph():
    """With ``maxsize`` 2, a third signature frees the graph used least
    recently; a hit refreshes its graph, which then outlives an older
    one."""
    made = []

    def capture(x, *, tag):
        made.append(_FakeGraph((tuple(x.shape), tag)))
        return made[-1]
    step = graphs.CompiledStep("fake", capture, maxsize=2)
    a, b, c = torch.zeros(1), torch.zeros(2), torch.zeros(3)
    assert step(a, tag=0) == ((1,), 0) and step(b, tag=0) == ((2,), 0)
    assert step(a, tag=0) == ((1,), 0) and len(made) == 2   # a hit
    step(c, tag=0)                        # frees b's graph, not a's
    assert [g.freed for g in made] == [False, True, False]
    step(a, tag=1)                        # another signature: frees a's
    assert [g.freed for g in made] == [True, True, False, False]
    assert len(step.graphs) == 2
    step(b, tag=0)                        # captured again
    assert len(made) == 5 and made[2].freed and not made[3].freed
    step.free()
    assert all(g.freed for g in made) and not step.graphs
    with pytest.raises(ValueError, match="maxsize"):
        graphs.CompiledStep("fake", capture, maxsize=0)


def test_graphed_cam_and_artifact_refuse_a_cpu_model():
    """No eager fallback: the graphed Grad-CAM and an artifact's graphs
    raise for a model on the CPU; ``cam_fn`` and ``Exported.call`` take
    the eager path on the CPU only because they are asked to run there."""
    from medmamba_tpu_torch.utils.export import (compile_module,
                                                 export_forward,
                                                 load_exported)

    model = tv.VSSM(**SMALL)
    x = preprocess(_uint8(5), size=32)
    cam = gradcam.compile_cam(model)
    assert cam.step.maxsize == gradcam.CAM_GRAPHS == 16
    for kw in (dict(), dict(target_class=[0, 1, 2])):
        with pytest.raises(RuntimeError, match="CUDA graphs need"):
            cam(x, **kw)
    eager = gradcam.cam_fn(model, torch.device("cpu"))
    np.testing.assert_array_equal(eager(x), gradcam.grad_cam(model, x))
    exp = load_exported(export_forward(model, image_size=32, device="cpu"))
    assert exp.graphs is None and exp.call(_uint8(6, size=32)).shape == (3, 4)
    with pytest.raises(RuntimeError, match="CUDA graphs need"):
        compile_module(exp._module)(_uint8(6, size=32))


def test_train_cli_logs_each_steps_own_loss(tmp_path, monkeypatch, capsys):
    """The step returns one buffer that each call overwrites, as a graph's
    replay does; the CLI reads losses two steps late, so it must keep a
    copy of each."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 2)):
        np.save(tmp_path / f"{split}_images.npy",
                rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8))
        np.save(tmp_path / f"{split}_labels.npy",
                (np.arange(n) % 3).reshape(n, 1).astype(np.int64))
    real, seen, buffer = trainer.train_step, [], torch.zeros(())

    def overwriting(*a, **kw):
        loss = real(*a, **kw)
        seen.append(loss.item())
        return buffer.copy_(loss)
    monkeypatch.setattr(trainer, "train_step", overwriting)
    out = train_cli.main(["--train_dir", str(tmp_path), "--val_dir",
                          str(tmp_path), "--batch_size", "2", "--epochs",
                          "1", "--image_size", "32", "--augmentation",
                          "--device", "cpu", "--save_dir",
                          str(tmp_path / "run"), "--log_every", "1"])
    logged = [float(v) for v in re.findall(r"loss:([0-9.]+)",
                                            capsys.readouterr().out)]
    assert len(seen) == 4 and len(set(seen)) == 4
    assert logged == [round(v, 3) for v in seen[:len(logged)]] and logged
    assert out["train_loss"] == pytest.approx(np.mean(seen), rel=1e-6)
    assert os.path.isfile(out["last_path"])
