"""The port's tensor parallelism against the JAX package, on the CPU.

* (a) ``shard_dims`` of medmamba_t shards exactly the parameters the JAX
  ``partition_params`` shards on a 4x2 mesh, on the matching dim of the
  port's layout (names through ``utils/convert.py``), the head replicated
  at 9 classes and sharded at 4;
* (c) the port's TP step in eight gloo ranks on the 4x2 ("data", "model")
  mesh equals the JAX TP step (``test_sharding.py``'s TP test: the tiny
  VSSM at 16^2, batch 4, augmentation off, drop path 0, weights through
  ``state_dict_from_jax``) to that test's loss tolerance, 1e-4 relative;
  the gradients AdamW is given (the port's shards gathered) within 1e-5
  of their scale of the JAX TP step's gradients (the same loss
  differentiated on the partitioned parameters and the sharded batch,
  whose loss is the step's to 1e-6), each gradient's scale its largest
  entry, leaving out the convolution biases in front of a BatchNorm,
  whose gradient is zero in exact arithmetic (``BIAS_BEFORE_BN``, as
  ``test_torch_port_compiled.py`` leaves them out); the BatchNorm running
  statistics within 1e-5 of the largest statistic; and, as the JAX DP
  test holds parameters, within 2.5e-3 absolute after AdamW (a near-zero
  first-step gradient may flip its update's sign).

The checks against one process are in ``test_torch_port_tensor_parallel.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from medmamba_tpu.data.transforms import preprocess as jax_preprocess
from medmamba_tpu.models.registry import create_model as jax_create_model
from medmamba_tpu.models.vssm import VSSM as JaxVSSM
from medmamba_tpu.parallel import mesh as jax_mesh
from medmamba_tpu.train.trainer import cross_entropy as jax_cross_entropy
from medmamba_tpu.train.trainer import init_state
from medmamba_tpu.train.trainer import make_optimizer as jax_optimizer
from medmamba_tpu.train.trainer import train_step as jax_train_step
from medmamba_tpu_torch.models.registry import create_model
from medmamba_tpu_torch.parallel.mesh import shard_dims
from medmamba_tpu_torch.utils.convert import (_tag_for, _untranslate,
                                              state_dict_from_jax)
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

TINY = dict(num_classes=3, depths=(1, 1), dims=(8, 16), d_state=4)
SIZE = 16
# the conv biases in front of a BatchNorm (test_torch_port_compiled.py's)
BIAS_BEFORE_BN = re.compile(r"conv33conv33conv11\.[14]\.bias$")


def _jax_specs(num_classes):
    """{port name: (JAX spec of the leaf under partition_params on a 4x2
    mesh, the leaf's layout tag)} of medmamba_t."""
    model = jax_create_model("T", num_classes, scan_impl="seq")
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0),
                           jnp.zeros((1, 32, 32, 3), jnp.float32)))["params"]
    mesh = jax_mesh.make_mesh(n_data=4, n_model=2)
    try:
        placed = jax_mesh.partition_params(
            jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes),
            mesh)
    finally:
        jax_mesh.set_active_mesh(None)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        out[_untranslate(keys)] = (tuple(leaf.sharding.spec),
                                   _tag_for(keys, leaf.ndim), leaf.ndim)
    return out


@pytest.mark.parametrize("num_classes", [9, 4])
def test_partition_rules_match_jax_partition_params(num_classes):
    want = _jax_specs(num_classes)
    got = shard_dims(create_model("T", num_classes, device="cpu"), 2)
    assert sorted(got) == sorted(want)
    for name, (spec, tag, ndim) in want.items():
        axes = [i for i, s in enumerate(spec) if s == "model"]
        assert len(axes) <= 1, (name, spec)
        jax_dim = axes[0] if axes else None
        if jax_dim is not None and tag == "linear":
            jax_dim = ndim - 1 - jax_dim      # flax (in, out) -> (out, in)
        assert tag != "conv_oihw" or jax_dim is None, name
        assert got[name] == jax_dim, (name, spec, got[name])
    assert (got["head.weight"] is None) == (num_classes == 9)
    n_sharded = sum(d is not None for d in got.values())
    # 10 SS2D blocks x (in_proj, out_proj, x_proj, dt_projs, A_logs, Ds),
    # 3 PatchMerging reductions, and the head where 2 divides it
    assert n_sharded == 63 + (num_classes == 4)


def _jax_tp_grads(state, params, images, labels, rng):
    """(loss, gradients) of ``jax_train_step``'s loss at ``state`` with
    ``params`` (partitioned) on the sharded batch, augmentation off: the
    gradients the JAX TP step hands AdamW."""
    rng = jax.random.fold_in(rng, state.step)
    k_aug, k_drop = jax.random.split(rng)

    @jax.jit
    def grads(params, images, labels):
        x = jax_preprocess(k_aug, images, size=SIZE, augment=False)

        def loss_fn(p):
            outs, _ = state.apply_fn(
                {"params": p, "batch_stats": state.batch_stats}, x, False,
                labels >= 0, rngs={"dropout": k_drop},
                mutable=["batch_stats"])
            return jax_cross_entropy(outs, labels)
        return jax.value_and_grad(loss_fn)(params)
    return grads(params, images, labels)


def test_tp_step_matches_the_jax_tp_step(tmp_path):
    """``test_sharding.py``'s TP test on its 4x2 mesh and batch 4, in the
    port's eight ranks."""
    model = JaxVSSM(**TINY, drop_path_rate=0.0, scan_impl="seq")
    state = init_state(model, jax.random.key(0),
                       jax_optimizer(1e-3, npz_mode=True),
                       input_shape=(1, SIZE, SIZE, 3))
    weights = state_dict_from_jax({"params": state.params,
                                   "batch_stats": state.batch_stats})
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (4,), dtype=np.int64)
    mesh = jax_mesh.make_mesh(n_data=4, n_model=2)
    try:
        tp_state = state.replace(
            params=jax_mesh.partition_params(state.params, mesh))
        si, sl = jax_mesh.shard_batch(mesh, images, labels)
        grad_loss, grads = _jax_tp_grads(tp_state, tp_state.params, si, sl,
                                         jax.random.key(1))
        grads = state_dict_from_jax({"params": grads})
        new, loss = jax_train_step(tp_state, si, sl, jax.random.key(1),
                                   augment=False, image_size=SIZE)
        want = state_dict_from_jax({"params": new.params,
                                    "batch_stats": new.batch_stats})
    finally:
        jax_mesh.set_active_mesh(None)
    np.testing.assert_allclose(float(grad_loss), float(loss), rtol=1e-6)
    got = ranks.spawn(ranks.tp_jax_step, 8, tmp_path,
                      dict(TINY, drop_path_rate=0.0), weights,
                      torch.from_numpy(images), torch.from_numpy(labels),
                      SIZE, n_model=2)
    held = [n for n in grads if not BIAS_BEFORE_BN.search(n)]
    assert len(held) == len(grads) - 4
    stats = {k: v for k, v in want.items()
             if k.endswith(("running_mean", "running_var"))}
    stat_scale = max(float(w.abs().max()) for w in stats.values())
    for g in got:
        np.testing.assert_allclose(g["loss"].item(), float(loss), rtol=1e-4)
        assert sorted(g["grads"]) == sorted(grads)
        for name in held:
            w = grads[name]
            scale = float(w.abs().max())
            assert float((g["grads"][name] - w).abs().max()) \
                <= 1e-5 * scale, (name, scale)
        for name, w in stats.items():
            assert float((g["state"][name] - w).abs().max()) \
                <= 1e-5 * stat_scale, name
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(g["state"][name].numpy(), w.numpy(),
                                       rtol=0, atol=2.5e-3, err_msg=name)
