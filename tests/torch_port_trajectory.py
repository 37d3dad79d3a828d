"""The port's training trajectory against the JAX package's, on the CPU.

The JAX package's ``tools/trajectory_parity.py`` holds that package
against the upstream torch reference, whose checkout this repository does
not carry; this harness holds the port against the JAX package instead,
over many steps, where a one-step check cannot see drift (the optimizer,
the BatchNorm running statistics, the masked loss, small errors
compounding). Every arm trains the same VSSM
from one init (JAX's ``init_state``, carried over with ``utils/convert.py:
state_dict_from_jax``) on one uint8 grating stream
(``medmamba_tpu_torch/tools/trajectory.py: make_grating_data``, made from
a numpy seed) with the NPZ recipe, augmentation off and drop path 0 (the
two packages draw from different generators):

* (a) one process: the port's ``train_step`` (plain scan) against JAX's
  ``train_step`` with ``scan_impl="seq"``;
* (b) two data ranks: the port in two gloo ranks against JAX's step on a
  2-device data mesh (``replicate_state``, ``shard_batch``);
* (c) a 1x2 model mesh: the port's TP step against JAX's
  ``partition_params`` step on a (1, 2) mesh.

The yardstick is a seed-noise arm, the port from another init seed:
``tools/trajectory.py: compare`` gives each arm's gaps against JAX
beside that arm's.
:func:`first_step_gaps` gives the first step's gradient gap of (b) and (c)
against one process, in the port and in JAX (the C2 question).

The quick tier runs short streams of the tiny VSSM
(``tests/test_torch_port_trajectory*.py``). ``python
tests/torch_port_trajectory.py`` runs every arm for the JAX tool's 500
steps at its defaults (32^2, 3 classes, dims (16, 32), batch 8) and
prints one JSON line. This module imports both packages; the port never
imports it.
"""
import json
import os
import re
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
if __name__ == "__main__":
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(_here), _here]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_port_ranks as ranks  # noqa: E402
from medmamba_tpu.data import transforms as jax_transforms  # noqa: E402
from medmamba_tpu.models.vssm import VSSM as JaxVSSM  # noqa: E402
from medmamba_tpu.parallel import mesh as jax_mesh  # noqa: E402
from medmamba_tpu.train import trainer as jax_trainer  # noqa: E402
from medmamba_tpu_torch.models.vssm import VSSM  # noqa: E402
from medmamba_tpu_torch.tools import trajectory  # noqa: E402
from medmamba_tpu_torch.train import trainer  # noqa: E402
from medmamba_tpu_torch.utils import convert  # noqa: E402

# the quick tier: the tiny VSSM of test_torch_port_tensor_parallel_jax.py
TINY = dict(num_classes=3, depths=(1, 1), dims=(8, 16), d_state=4)
SIZE, BATCH = 16, 8
# the full run: the JAX tool's defaults (tools/trajectory_parity.py:118-120)
FULL = dict(num_classes=3, depths=(1, 1), dims=(16, 32))
FULL_SIZE, FULL_STEPS, N_VAL = 32, 500, 256
FULL_JOIN_S = 3600
DATA_SEED, VAL_SEED, NOISE_SEED = 11, 12, 5
# the conv biases in front of a BatchNorm, whose gradient is zero in exact
# arithmetic (test_torch_port_tensor_parallel_jax.py's)
BIAS_BEFORE_BN = re.compile(r"conv33conv33conv11\.[14]\.bias$")
# the gates, fixed before the first full run
FIRST_STEPS, FIRST_REL = 5, 1e-5
RATIO = 0.1
# C2: the port's first-step gap within this factor of JAX's own
GAP_FACTOR = 3.0


class Setup:
    """One harness configuration: the JAX state from ``init_state``, its
    weights in the port's names, the model arguments of both packages, the
    stream and the noise arm's weights (the port's init from another
    seed)."""

    def __init__(self, model_kw, size, steps, batch=BATCH, n_val=0):
        self.model_kw = dict(model_kw, drop_path_rate=0.0)
        self.size = size
        self.jax_model = JaxVSSM(**self.model_kw, scan_impl="seq")
        self.state = jax_trainer.init_state(
            self.jax_model, jax.random.key(0),
            jax_trainer.make_optimizer(1e-3, npz_mode=True),
            input_shape=(1, size, size, 3))
        self.weights = convert.state_dict_from_jax(
            {"params": self.state.params,
             "batch_stats": self.state.batch_stats})
        self.noise_weights = VSSM(**self.model_kw, generator=torch.Generator()
                                  .manual_seed(NOISE_SEED)).state_dict()
        self.images, self.labels = trajectory.grating_stream(
            steps, batch, size, self.model_kw["num_classes"], DATA_SEED)
        self.val = (trajectory.make_grating_data(
            n_val, size, self.model_kw["num_classes"], VAL_SEED)
            if n_val else None)

    def port(self, weights=None) -> dict:
        """The port in this process on the CPU (the plain scan), on one
        thread as the ranks run."""
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return trajectory.run_arm(
                self.model_kw, self.weights if weights is None else weights,
                self.images, self.labels, device="cpu",
                image_size=self.size, val=self.val)
        finally:
            torch.set_num_threads(threads)

    def noise(self) -> dict:
        return self.port(self.noise_weights)

    def port_mesh(self, root, layout) -> "ranks.Ranks":
        """(b) (``layout`` "data") or (c) ("model") started in two gloo
        ranks; ``results()`` gives each rank's losses, final state and
        first-step gradients."""
        first = (torch.from_numpy(self.images[0]),
                 torch.from_numpy(self.labels[0]))
        return ranks.start(ranks.trajectory, 2, root, self.model_kw,
                           self.weights, self.images, self.labels, first,
                           self.size, n_model=2 if layout == "model" else 1)

    def placed(self, layout):
        """(a copy of the initial JAX state placed for ``layout``, its
        mesh, made the active one; None on one device). The step donates
        its state, so every arm starts from a copy."""
        state = jax.tree.map(jnp.array, self.state)
        if layout is None:
            return state, None
        if layout == "data":
            mesh = jax_mesh.make_mesh(devices=jax.devices()[:2])
            return jax_mesh.replicate_state(state, mesh), mesh
        mesh = jax_mesh.make_mesh(n_data=1, n_model=2,
                                  devices=jax.devices()[:2])
        return state.replace(
            params=jax_mesh.partition_params(state.params, mesh)), mesh

    def jax(self, layout=None) -> dict:
        """JAX's ``train_step`` on the stream: on one device (``layout``
        None), on a 2-device data mesh ("data") or a (1, 2) model mesh
        ("model"). The losses, the final state in the port's names and,
        with a validation split, the accuracy."""
        try:
            state, mesh = self.placed(layout)
            losses = []
            for im, lb in zip(self.images, self.labels):
                if mesh is not None:
                    im, lb = jax_mesh.shard_batch(mesh, im, lb)
                state, loss = jax_trainer.train_step(
                    state, im, lb, jax.random.key(1), augment=False,
                    image_size=self.size)
                losses.append(loss)
            acc = None
            if self.val is not None:
                correct, _ = jax_trainer.eval_step(state, *self.val,
                                                   image_size=self.size)
                acc = float(correct) / len(self.val[1])
        finally:
            jax_mesh.set_active_mesh(None)
        return dict(losses=np.asarray([float(x) for x in losses]), acc=acc,
                    state=convert.state_dict_from_jax(
                        {"params": jax.device_get(state.params),
                         "batch_stats": jax.device_get(state.batch_stats)}))

    def jax_grads(self, layout=None) -> dict:
        """The gradients JAX's first step hands AdamW on the stream's
        first batch, in the port's names, on one device or ``layout``'s
        mesh (as :meth:`jax`)."""
        im, lb = self.images[0], self.labels[0]
        try:
            state, mesh = self.placed(layout)
            if mesh is not None:
                im, lb = jax_mesh.shard_batch(mesh, im, lb)
            size = self.size

            def loss_fn(p, images, labels):
                x = jax_transforms.preprocess(
                    jax.random.key(0), images, size=size, augment=False)
                outs, _ = state.apply_fn(
                    {"params": p, "batch_stats": state.batch_stats}, x,
                    False, labels >= 0, rngs={"dropout": jax.random.key(0)},
                    mutable=["batch_stats"])
                return jax_trainer.cross_entropy(outs, labels)
            grads = jax.jit(jax.grad(loss_fn))(state.params, im, lb)
        finally:
            jax_mesh.set_active_mesh(None)
        return convert.state_dict_from_jax({"params": jax.device_get(grads)})

    def port_grads(self) -> dict:
        """The gradients the port's first step hands AdamW, one process."""
        model = VSSM(**self.model_kw)
        model.load_state_dict(self.weights)
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        grads = {}
        opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.clone() for n, p in model.named_parameters()}))
        trainer.train_step(model, opt, torch.from_numpy(self.images[0]),
                           torch.from_numpy(self.labels[0]),
                           generator=torch.Generator().manual_seed(0),
                           image_size=self.size)
        return grads


def grad_gap(got: dict, want: dict) -> dict:
    """The relative L2 gap of two gradient dicts, in total and per
    parameter, and the parameters in order of their share of it."""
    gap = trajectory.param_gap(got, want, list(want))
    sq = {k: float((got[k].double() - want[k].double()).square().sum())
          for k in want}
    total = sum(sq.values())
    gap["order"] = sorted(sq, key=sq.get, reverse=True)
    gap["share"] = {k: v / max(total, 1e-300) for k, v in sq.items()}
    return gap


def first_step_gaps(setup: Setup, ranked: list, layout: str,
                    jax_grads=None) -> dict:
    """C2 on the CPU: the first step's gradient gap against one process of
    two data ranks (``layout`` "data") or of the 1x2 model mesh ("model"),
    in the port (rank 0's gradients, from :meth:`Setup.port_mesh`) and in
    JAX (its mesh against one device; ``jax_grads``, the pair, where
    computed before)."""
    mesh_g, one_g = jax_grads or (setup.jax_grads(layout), setup.jax_grads())
    return dict(port=grad_gap(ranked[0]["grads"], setup.port_grads()),
                jax=grad_gap(mesh_g, one_g))


def quick_mesh_run(layout: str, steps: int, root) -> dict:
    """The quick tier of (b) or (c): the tiny VSSM's ``steps`` steps in
    two ranks against JAX's mesh, beside the noise arm, and C2's
    first-step gaps. The JAX arms and the noise arm run while the ranks
    do."""
    setup = Setup(TINY, SIZE, steps)
    started = setup.port_mesh(root, layout)
    jax_arm, noise = setup.jax(layout), setup.noise()
    jax_grads = (setup.jax_grads(layout), setup.jax_grads())
    ranked = started.results()
    return dict(arms=trajectory.compare(ranked[0], jax_arm, noise),
                ranked=ranked,
                gaps=first_step_gaps(setup, ranked, layout, jax_grads))


def main() -> None:
    import tempfile
    import time

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-1.0, 0.0, 64))     # ROADMAP.md §C, C1
    setup = Setup(FULL, FULL_SIZE, FULL_STEPS, n_val=N_VAL)
    port, noise = setup.port(), setup.noise()
    out = {"steps": FULL_STEPS, "size": FULL_SIZE, "batch": BATCH,
           "model": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in FULL.items()},
           "noise_acc": noise["acc"]}
    for layout in (None, "data", "model"):
        name = layout or "one"
        t0 = time.perf_counter()
        if layout is None:
            arm = port
        else:
            with tempfile.TemporaryDirectory() as root:
                ranked = setup.port_mesh(root, layout).results(FULL_JOIN_S)
            arm = ranked[0]
        j = setup.jax(layout)
        out[name] = trajectory.compare(arm, j, noise)
        out[name]["acc"] = dict(port=arm.get("acc"), jax=j["acc"])
        if layout is not None:
            gaps = first_step_gaps(setup, ranked, layout)
            out[name]["first_step_grad_gap"] = {
                side: dict(total=g["total"], top=[
                    (k, g["share"][k]) for k in g["order"][:5]])
                for side, g in gaps.items()}
        out[name]["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
