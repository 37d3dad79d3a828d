"""The port's ViT (``models/vit.py``) against the JAX package's, on the CPU.

A tiny ViT (32^2 input, patch 8, width 32, depth 2, 2 heads), its JAX
variables drawn with numpy from their shapes (the zero-initialised head
and cls token randomised with the rest) and carried across with
``vit_state_dict_from_jax``. Logits agree to 1e-4 (as
``test_torch_port_model.py``), CAMs to 1e-4 absolute (as
``test_torch_port_gradcam.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.eval import gradcam as jg
from medmamba_tpu.models import vit as jvit
from medmamba_tpu_torch.eval import gradcam as tg
from medmamba_tpu_torch.models import vit as tvit
from medmamba_tpu_torch.utils.convert_backbones import vit_state_dict_from_jax
from test_torch_port_model import _init

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, num_classes=5)
TOL = dict(rtol=1e-4, atol=1e-4)
CAM_TOL = 1e-4


def _x(seed, b=2, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)) \
        .astype(np.float32)


def _pair(seed, **kw):
    x = _x(seed)
    jm = jvit.VisionTransformer(**TINY, **kw)
    variables = _init(jm, x, seed, True)
    tm = tvit.VisionTransformer(img_size=32, **TINY, **kw)
    tm.load_state_dict(vit_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm.eval(), x


@pytest.mark.parametrize("rep", [None, 16], ids=["head", "pre_logits"])
def test_logits_match_jax(rep):
    jm, variables, tm, x = _pair(0, representation_size=rep)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, True))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1       # the head is not the zero init
    np.testing.assert_allclose(got, want, **TOL)


def test_random_init_has_the_jax_head_and_shapes():
    """The head starts at zeros, as the JAX module's (so a random ViT's
    logits are zero); every other parameter has the JAX shape."""
    tm = tvit.VisionTransformer(img_size=32, **TINY)
    assert not tm.head.weight.any() and not tm.head.bias.any()
    with torch.no_grad():
        assert not tm(torch.from_numpy(_x(1))).any()
    _, variables, _, _ = _pair(1)
    want = vit_state_dict_from_jax(variables)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_reshape_transform_matches_jax():
    tokens = np.random.default_rng(2).standard_normal((2, 17, 8)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        tvit.vit_reshape_transform(torch.from_numpy(tokens), grid=4).numpy(),
        np.asarray(jvit.vit_reshape_transform(jnp.asarray(tokens), grid=4)))


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("target_class", [None, [3, 1]])
def test_cam_matches_jax(block, target_class):
    """At ``blocks_{i}.norm1`` (``cam_backbones`` targets the last block)
    through ``vit_reshape_transform``."""
    jm, variables, tm, x = _pair(3)
    path = (f"blocks_{block}", "norm1")
    tc = None if target_class is None else np.array(target_class)
    want = jg.grad_cam(jm, variables, jnp.asarray(x), target_class=tc,
                       target_path=path,
                       reshape_transform=functools.partial(
                           jvit.vit_reshape_transform, grid=4))
    got = tg.grad_cam(tm, torch.from_numpy(x), target_class=tc,
                      target_path=path,
                      reshape_transform=functools.partial(
                          tvit.vit_reshape_transform, grid=4))
    assert got.shape == want.shape == (2, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=CAM_TOL)
    assert want.max() - want.min() > 0.5


@pytest.mark.parametrize("path", ["blocks_2.norm1", "blocks_0.norm2",
                                  "norm", "blocks.0.attn"])
def test_unknown_path_raises(path):
    _, _, tm, x = _pair(4)
    with pytest.raises(ValueError, match=path.replace(".", r"\.")):
        tg.grad_cam(tm, torch.from_numpy(x), target_paths=[path])
    assert all(not m.taps for m in tm.modules() if hasattr(m, "taps"))


def test_port_block_name_reaches_the_same_tap():
    _, _, tm, _ = _pair(5)
    assert tm.tap_site("blocks_1.norm1") == tm.tap_site("blocks.1.norm1") \
        == tm.tap_site(("blocks_1", "norm1"))
