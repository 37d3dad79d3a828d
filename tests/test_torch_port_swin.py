"""The port's Swin (``models/swin.py``) against the JAX package's, on the CPU.

A tiny Swin whose maps need padding and whose odd blocks shift: 40^2 input,
patch 4 (a 10 x 10 map, padded to 12 x 12 for window 4, shift 2), depths
(2, 2) (the second stage at 5 x 5, padded to 8 x 8). JAX variables drawn
with numpy from their shapes and carried across with
``swin_state_dict_from_jax``. The relative index and the shift masks equal
the JAX values exactly; logits agree to 1e-4, CAMs at ``norm`` to 1e-4
absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.eval import gradcam as jg
from medmamba_tpu.models import swin as jswin
from medmamba_tpu_torch.eval import gradcam as tg
from medmamba_tpu_torch.models import swin as tswin
from medmamba_tpu_torch.utils.convert_backbones import (
    swin_state_dict_from_jax)
from test_torch_port_model import _init

TINY = dict(patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, num_classes=5, drop_path_rate=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)
CAM_TOL = 1e-4


def _pair(seed, size=40):
    x = np.random.default_rng(seed).standard_normal((2, size, size, 3)) \
        .astype(np.float32)
    jm = jswin.SwinTransformer(**TINY)
    variables = _init(jm, x, seed, True)
    tm = tswin.SwinTransformer(**TINY)
    tm.load_state_dict(swin_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm.eval(), x


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_relative_position_index_equals_jax(ws):
    got = tswin._relative_position_index(ws)
    want = jswin._relative_position_index(ws)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hp, wp, ws, ss", [(12, 12, 4, 2), (8, 8, 4, 2),
                                            (7, 7, 7, 3), (14, 21, 7, 3)])
def test_attn_mask_equals_jax(hp, wp, ws, ss):
    """(7, 7, 7, 3): Swin-T's last stage at 224^2, one window and a live
    mask (the reference quirk)."""
    got = tswin._attn_mask(hp, wp, ws, ss)
    want = np.asarray(jswin._attn_mask(hp, wp, ws, ss))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got == -100.0).any() and set(np.unique(got)) == {-100.0, 0.0}


def test_window_partition_and_reverse_equal_jax():
    x = np.random.default_rng(1).standard_normal((2, 8, 12, 3)) \
        .astype(np.float32)
    win = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        win.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        tswin.window_reverse(win, 4, 8, 12).numpy(), x)


@pytest.mark.parametrize("size", [40, 32], ids=["padded", "whole_windows"])
def test_logits_match_jax(size):
    jm, variables, tm, x = _pair(2, size)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, True))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cam_at_norm_matches_jax():
    jm, variables, tm, x = _pair(3)
    want = jg.grad_cam(jm, variables, jnp.asarray(x), target_path=("norm",))
    got = tg.grad_cam(tm, torch.from_numpy(x), target_path=("norm",))
    assert got.shape == want.shape == (2, 40, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=CAM_TOL)
    assert want.max() - want.min() > 0.5
    with pytest.raises(ValueError, match="layers_0"):
        tg.grad_cam(tm, torch.from_numpy(x), target_paths=["layers_0"])


def test_reference_state_dict_with_its_index_buffers_loads_strictly():
    """A reference ``.pth`` also holds each block's
    ``relative_position_index``; it loads with strict=True and changes
    nothing (the index is recomputed)."""
    _, variables, tm, x = _pair(4)
    sd = swin_state_dict_from_jax(variables)
    for i, depth in enumerate(TINY["depths"]):
        for j in range(depth):
            sd[f"layers.{i}.blocks.{j}.attn.relative_position_index"] = \
                torch.zeros(16, 16, dtype=torch.long)
    fresh = tswin.SwinTransformer(**TINY)
    fresh.load_state_dict(sd, strict=True)
    fresh.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(x)).numpy(),
                                      tm(torch.from_numpy(x)).numpy())
    assert "layers.0.blocks.0.attn.relative_position_index" not in \
        fresh.state_dict()
