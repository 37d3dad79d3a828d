"""The port's Grad-CAM (``eval/gradcam.py`` and the model's taps) against the
JAX package's, on the CPU.

The tiny model of ``tests/test_eval.py`` (depths (1, 1), dims (8, 16),
d_state 4, 16^2 input), its JAX variables drawn with numpy from their shapes
(no flax init) and carried into the port with ``state_dict_from_jax``; the
JAX side scans with ``selective_scan_seq``, the port's with its plain scan
(a CPU tensor never reaches the kernels). CAMs agree to 1e-4 absolute;
overlays exactly (uint8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.eval import gradcam as jg
from medmamba_tpu.models import vssm as jv
from medmamba_tpu_torch.eval import gradcam as tg
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_model import _init

TINY = dict(num_classes=3, depths=(1, 1), dims=(8, 16), d_state=4,
            drop_path_rate=0.0)
CAM_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)) \
        .astype(np.float32)
    jm = jv.VSSM(**TINY, scan_impl="seq")
    variables = _init(jm, x, 3, True)
    tm = tv.VSSM(**TINY)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm.eval(), x


CASES = {
    "default": dict(),
    "mid_conv1x1": dict(target_paths=[("layers_0", "blocks_0", "conv1x1")]),
    "two_paths": dict(target_paths=[("layers_0", "blocks_0", "conv1x1"),
                                    ("layers_1", "blocks_0", "conv1x1")]),
    "conv_bn": dict(target_paths=[("layers_1", "blocks_0", "conv_bn2")]),
    "target_class": dict(target_class=np.array([1, 2])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_cam_matches_jax(models, case):
    jm, variables, tm, x = models
    kw = CASES[case]
    want = jg.grad_cam(jm, variables, jnp.asarray(x), **kw)
    got = tg.grad_cam(tm, torch.from_numpy(x), **kw)
    assert got.shape == want.shape == (2, 16, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=CAM_TOL)
    assert want.max() - want.min() > 0.5


@pytest.mark.parametrize("blocks", [False, True], ids=["targets", "blocks"])
@pytest.mark.parametrize("case", ["default", "mid_conv1x1", "two_paths"])
def test_grad_cam_at_its_own_activations_is_unchanged(models, case, blocks):
    """The model's own activations, substituted at the targets (and at
    every block's output), give its CAM bit for bit: the gradient passes
    through each substitution, so in the two-path case the upstream
    target's still flows through the downstream target."""
    _, _, tm, x = models
    xt = torch.from_numpy(x)
    paths = [".".join(p) for p in
             CASES[case].get("target_paths") or [tg.default_target_path(tm)]]
    assert tg.block_paths(tm) == ["layers_0.blocks_0", "layers_1.blocks_0"]
    sites = paths + (tg.block_paths(tm) if blocks else [])
    acts = tg.target_activations(tm, xt, sites)
    # (side, channels) of a stage's conv branch: half the stage's width;
    # a block's output: the whole width
    width = {"layers_0": (4, 4), "layers_1": (2, 8)}
    assert [tuple(a.shape) for a in acts[:len(paths)]] == [
        (2, width[p[:8]][0], width[p[:8]][0], width[p[:8]][1])
        for p in paths]
    assert [tuple(a.shape) for a in acts[len(paths):]] == (
        [(2, 4, 4, 8), (2, 2, 2, 16)] if blocks else [])
    np.testing.assert_array_equal(
        tg.grad_cam(tm, xt, target_paths=paths,
                    substitute=dict(zip(sites, acts))),
        tg.grad_cam(tm, xt, target_paths=paths))


def test_grad_cam_takes_the_substituted_activations(models):
    _, _, tm, x = models
    xt = torch.from_numpy(x)
    path = ["layers_0.blocks_0.conv1x1"]
    zero = torch.zeros_like(tg.target_activations(tm, xt, path)[0])
    cam = tg.grad_cam(tm, xt, target_paths=path, substitute={path[0]: zero})
    assert cam.shape == (2, 16, 16) and not cam.any()
    # at a block's output the CAM changes, and no tap is left behind
    blk = "layers_0.blocks_0"
    moved = tg.target_activations(tm, xt, [blk])[0].flip(-1)
    assert np.abs(tg.grad_cam(tm, xt, target_paths=path,
                              substitute={blk: moved})
                  - tg.grad_cam(tm, xt, target_paths=path)).max() > 1e-2
    assert all(not m.taps for m in tm.modules() if hasattr(m, "taps"))


def test_port_module_names_reach_the_same_taps(models):
    _, _, tm, x = models
    xt = torch.from_numpy(x)
    assert tg.default_target_path(tm) == ("layers_1", "blocks_0", "conv1x1")
    for jax_path, port_path in (
            ("layers_1.blocks_0.conv1x1",
             "layers.1.blocks.0.conv33conv33conv11.7"),
            ("layers_0.blocks_0.conv_bn0",
             "layers.0.blocks.0.conv33conv33conv11.0"),
            ("layers_0.blocks_0", "layers.0.blocks.0"),
            ("layers_0", "layers.0")):
        assert tm.tap_site(jax_path) == tm.tap_site(port_path)
        np.testing.assert_array_equal(
            tg.grad_cam(tm, xt, target_path=jax_path.split(".")),
            tg.grad_cam(tm, xt, target_paths=[port_path]))


@pytest.mark.parametrize("path", ["layers_1.blocks_0.conv9x9", "layers_5",
                                  "layers_0.blocks_3", "head"])
def test_unknown_path_raises(models, path):
    _, _, tm, x = models
    with pytest.raises(ValueError, match=path.replace(".", r"\.")):
        tg.grad_cam(tm, torch.from_numpy(x), target_paths=[path])
    # the model is left as it was: no tap, parameters trainable again
    assert all(not m.taps for m in tm.modules() if hasattr(m, "taps"))


def test_grad_cam_leaves_the_model_as_it_was(models):
    _, _, tm, x = models
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()
    flags = [p.requires_grad for p in tm.parameters()]
    tg.grad_cam(tm, torch.from_numpy(x),
                target_paths=["layers_0.blocks_0.conv1x1"])
    assert tm.training and flags == [p.requires_grad for p in tm.parameters()]
    assert all(p.grad is None for p in tm.parameters())
    assert all(not m.taps for m in tm.modules() if hasattr(m, "taps"))
    after = tm.state_dict()
    tm.eval()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_state_dict_keys_unchanged_by_the_taps(models):
    """The taps add no parameter or buffer: the keys are exactly those of
    the JAX model's variables, so the .pth files of earlier versions load
    with strict=True."""
    _, variables, tm, _ = models
    assert set(tm.state_dict()) == set(state_dict_from_jax(variables))
    fresh = tv.VSSM(**TINY)
    fresh.load_state_dict(tm.state_dict(), strict=True)


def test_show_cam_on_image_matches_jax_exactly():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    # the ends and the entry edges of the 256-entry table
    mask.flat[:6] = [0.0, 1.0, 0.5, 1 / 256, 255 / 256, 0.99999994]
    want = jg.show_cam_on_image(img, mask)
    got = tg.show_cam_on_image(img, mask)
    assert got.dtype == np.uint8 and got.shape == (16, 16, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tg.show_cam_on_image(img, mask, use_rgb=False, image_weight=0.3),
        jg.show_cam_on_image(img, mask, use_rgb=False, image_weight=0.3))
    with pytest.raises(ValueError):
        tg.show_cam_on_image(img * 2, mask)
