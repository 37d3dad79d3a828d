"""The port's MobileNetV2 (``models/mobilenet.py``) against the JAX
package's, on the CPU, at alpha 0.35.

JAX variables (BatchNorm running statistics randomised) drawn with numpy
from their shapes and carried across with ``mobilenet_state_dict_from_jax``.
Eval logits against ``apply(v, x, False)`` at 32^2, to 1e-4. One
train-mode forward's logits and updated statistics against ``apply(v, x,
True, True, mutable=["batch_stats"])`` at 64^2, to 1e-4: at 32^2 the last
stages are 1 x 1, a batch of 2 gives each BatchNorm channel two values, and
the train-mode forward has no float32 answer (the JAX module's own float32
and float64 logits differ by 1.6). At 64^2 flax's BatchNorm, which takes
the batch variance as E[x^2] - E[x]^2, still loses 2.6e-4 of the logits in
float32 (the port 3e-5), so that test holds the port against the JAX module
evaluated in float64 (``jax.enable_x64``), as ``test_torch_port_decoder.py``
does. The CAM at ``head_conv.conv`` at 64^2 (at 32^2 that map is 1 x 1,
and its CAM all zeros) to 1e-4 absolute. The JAX ``grad_cam`` calls
``model.apply(v, x, True)``, which MobileNetV2 reads as ``train=True`` (and
raises, its batch statistics being immutable there), so the JAX side runs
through ``_EvalMobileNetV2``, a thin subclass defined here that calls the
module with ``train=False``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.eval import gradcam as jg
from medmamba_tpu.models import mobilenet as jmob
from medmamba_tpu_torch.eval import gradcam as tg
from medmamba_tpu_torch.models import mobilenet as tmob
from medmamba_tpu_torch.utils.convert_backbones import (
    mobilenet_state_dict_from_jax, mobilenet_state_dict_to_jax)
from test_torch_port_model import _init

ALPHA = 0.35
TOL = dict(rtol=1e-4, atol=1e-4)
CAM_TOL = 1e-4


class _EvalMobileNetV2(jmob.MobileNetV2):
    """``MobileNetV2`` in eval mode behind ``grad_cam``'s
    ``apply(v, x, True)``: the same module paths and variables."""

    def __call__(self, x, deterministic=True):
        return super().__call__(x, False)


def _pair(seed, size=32, **kw):
    x = np.random.default_rng(seed).standard_normal((2, size, size, 3)) \
        .astype(np.float32)
    jm = jmob.MobileNetV2(num_classes=5, alpha=ALPHA, **kw)
    variables = _init(jm, x, seed, False)
    tm = tmob.MobileNetV2(num_classes=5, alpha=ALPHA, **kw)
    tm.load_state_dict(mobilenet_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm, x


def test_eval_logits_match_jax():
    jm, variables, tm, x = _pair(0)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_train_mode_logits_and_batch_statistics_match_jax():
    """Dropout off on both sides (the JAX forward is deterministic); the
    running statistics move as flax's: momentum 0.9, biased variance."""
    jm, variables, tm, x = _pair(1, size=64, dropout=0.0)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        want, upd = jax.jit(lambda v, a: jm.apply(
            v, a, True, True, mutable=["batch_stats"]))(
                v64, jnp.asarray(x, jnp.float64))
        want, upd = jax.tree_util.tree_map(np.asarray, (want, upd))
    got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    stats = mobilenet_state_dict_to_jax(tm.state_dict())["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    assert len(leaves) == 2 * sum(
        1 for m in tm.modules() if isinstance(m, tmob.MaskedBatchNorm))
    for path, w in leaves:
        g = stats
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, **TOL)
    assert all(m.num_batches_tracked.item() == 1 for m in tm.modules()
               if isinstance(m, tmob.MaskedBatchNorm))


def test_dropout_in_training_draws_from_the_generator():
    _, _, tm, x = _pair(2)
    tm.train()
    with pytest.raises(ValueError, match="Generator"):
        tm(torch.from_numpy(x))
    runs = [tm(torch.from_numpy(x), torch.Generator().manual_seed(7))
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


@pytest.mark.parametrize("target_class", [None, [4, 0]])
def test_cam_at_head_conv_matches_jax_in_eval_mode(target_class):
    _, variables, tm, x = _pair(3, size=64)
    jm = _EvalMobileNetV2(num_classes=5, alpha=ALPHA)
    tc = None if target_class is None else np.array(target_class)
    want = jg.grad_cam(jm, variables, jnp.asarray(x), target_class=tc,
                       target_path=("head_conv", "conv"))
    tm.train()
    got = tg.grad_cam(tm, torch.from_numpy(x), target_class=tc,
                      target_path=("head_conv", "conv"))
    assert tm.training                   # restored after the eval-mode CAM
    assert got.shape == want.shape == (2, 64, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=CAM_TOL)
    assert want.max() - want.min() > 0.5
    # the port's module name of the same convolution
    np.testing.assert_array_equal(
        tg.grad_cam(tm, torch.from_numpy(x), target_class=tc,
                    target_paths=["features.18.0"]), got)


def test_the_jax_module_called_as_grad_cam_calls_it_raises():
    """The fault of the JAX CLI that the port does not copy: the third
    positional argument is ``train``."""
    jm, variables, _, x = _pair(4)
    with pytest.raises(Exception, match="batch_stats"):
        jm.apply(variables, jnp.asarray(x), True)


@pytest.mark.parametrize("path", ["head_conv", "head_conv.bn", "stem.conv",
                                  "features.17.conv.0"])
def test_unknown_path_raises(path):
    _, _, tm, x = _pair(5)
    with pytest.raises(ValueError, match=path.replace(".", r"\.")):
        tg.grad_cam(tm, torch.from_numpy(x), target_paths=[path])
