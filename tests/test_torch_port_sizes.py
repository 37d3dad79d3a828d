"""medmamba_s, _b and _te in the port against the JAX package, on the CPU.

* Every size's full-width parameters: the port's ``state_dict`` names and
  shapes (built on the meta device, so nothing is allocated) against the
  JAX model's variables (``jax.eval_shape`` of ``init``, nothing compiled)
  carried through the converter's name map and layouts.
* B's widths (dims 128-1024) at depths cut to (1, 1, 2, 1), 64^2 input:
  eval logits, and one train-mode loss, its parameter gradients and the
  BatchNorm statistics, against the JAX model with ``scan_impl="seq"`` to
  1e-4, as ``test_torch_port_train.py`` holds medmamba_t's slice. The
  depths are cut because a full-depth B or S JAX forward at 32^2 takes
  about 55 s to compile and run on the CPU; the widths, which give the
  scan its launch shapes, are B's own. 64^2, not 32^2: at 32^2 the last
  stage runs its BatchNorm on 1x1 maps of 2 valid rows, whose gradients
  are ill-conditioned (a convolution bias of layers.0 read 2% apart
  between the two float32 runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.models import registry as jreg
from medmamba_tpu.models import vssm as jv
from medmamba_tpu.train.trainer import cross_entropy as jax_cross_entropy
from medmamba_tpu_torch.models import registry as treg
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.train import trainer
from medmamba_tpu_torch.utils.convert import (_leaves, _tag_for,
                                              _to_torch_layout, _untranslate,
                                              state_dict_from_jax,
                                              state_dict_to_jax)
from test_torch_port_model import _init
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

NUM_CLASSES = 9
B_CUT = dict(num_classes=4, depths=(1, 1, 2, 1),
             dims=treg.MODEL_CONFIGS["B"].dims, drop_path_rate=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)


def _converted_shapes(variables) -> dict:
    """{state-dict key: shape} of JAX variables given as shapes: the
    converter's names and layouts, on zero-stride arrays."""
    out = {}
    for coll in ("params", "batch_stats"):
        for keys, leaf in _leaves(variables.get(coll, {})):
            arr = np.broadcast_to(np.float32(0), leaf.shape)
            out[_untranslate(keys)] = tuple(
                _to_torch_layout(arr, _tag_for(keys, arr.ndim)).shape)
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[:-len("running_mean")] + "num_batches_tracked"] = ()
    return out


@pytest.mark.parametrize("size", ["S", "B", "Te"])
def test_full_width_state_dict_matches_the_converted_jax_params(size):
    cfg = treg.MODEL_CONFIGS[size]
    jcfg = jreg.MODEL_CONFIGS[size]
    assert (tuple(cfg.depths), tuple(cfg.dims), cfg.d_state) == (
        tuple(jcfg.depths), tuple(jcfg.dims), jcfg.d_state)
    jm = jv.VSSM(num_classes=NUM_CLASSES, depths=jcfg.depths,
                 dims=jcfg.dims, d_state=jcfg.d_state)
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 224, 224, 3)), True),
        jax.random.key(0))
    with torch.device("meta"):
        tm = tv.VSSM(num_classes=NUM_CLASSES, depths=cfg.depths,
                     dims=cfg.dims, d_state=cfg.d_state)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == _converted_shapes(shapes)
    n_blocks = sum(cfg.depths)
    assert sum(k.endswith("ln_1.weight") for k in got) == n_blocks
    assert got["head.weight"] == (NUM_CLASSES, cfg.dims[-1])


def _batch(seed, b=3, size=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    labels = np.array([0, 2, -1][:b] + [1] * max(0, b - 3), np.int64)
    return x, labels


@pytest.fixture(scope="module")
def b_cut():
    x, labels = _batch(11, size=64)
    jm = jv.VSSM(**B_CUT, scan_impl="seq")
    variables = _init(jm, x, 11, True)
    tm = tv.VSSM(**B_CUT)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm, x, labels


def test_b_widths_eval_logits_match_jax(b_cut):
    jm, variables, tm, x, _ = b_cut
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, True))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_b_widths_train_step_loss_grads_and_stats_match_jax(b_cut):
    jm, variables, tm, x, labels = b_cut
    mask = labels >= 0

    def loss_fn(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), False, jnp.asarray(mask),
                            mutable=["batch_stats"])
        return jax_cross_entropy(out, jnp.asarray(labels)), upd
    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    tm.train().zero_grad(set_to_none=True)
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
