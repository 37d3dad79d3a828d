"""The CAM backbones' schema, weights and CLI against the JAX package's, on
the CPU.

* At full width, every factory's parameter count and shapes (the port built
  on the meta device, so nothing is allocated) against ``jax.eval_shape`` of
  the JAX init: ViT B/16, B/32, L/16, L/32 and H/14, Swin T/S/B/L and
  MobileNetV2 at 224^2 and 1000 classes, and the default ``VSSMSeg``.
* At small widths, the state-dict keys equal those the reference-to-flax
  maps of ``tests/test_backbone_parity.py`` read, and ``*_state_dict_to_jax``
  gives what those maps give; each ``_from_jax`` / ``_to_jax`` round trip is
  exact.
* ``cli.cam_backbones --device cpu`` for each arch at full width and a
  64^2 PNG, from a ``.pth`` written from numpy-drawn JAX variables: its
  prediction, logits (1e-4) and CAM (1e-4 absolute) against the JAX
  module's and ``grad_cam``'s on those variables (MobileNetV2 through the
  eval-mode wrapper of ``test_torch_port_mobilenet.py``); without
  ``--checkpoint_path`` or ``--random-ok`` it raises, as the JAX CLI does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.data.transforms import preprocess as jax_preprocess
from medmamba_tpu.eval import gradcam as jg
from medmamba_tpu.models import decoder as jdec
from medmamba_tpu.models import mobilenet as jmob
from medmamba_tpu.models import swin as jswin
from medmamba_tpu.models import vit as jvit
from medmamba_tpu_torch.cli import cam_backbones
from medmamba_tpu_torch.models import decoder as tdec
from medmamba_tpu_torch.models import mobilenet as tmob
from medmamba_tpu_torch.models import swin as tswin
from medmamba_tpu_torch.models import vit as tvit
from medmamba_tpu_torch.utils import convert_backbones as cb
from medmamba_tpu_torch.utils import png
from test_backbone_parity import (_mnv2_torch_to_flax, _swin_torch_to_flax,
                                  _vit_torch_to_flax)
from test_torch_port_mobilenet import _EvalMobileNetV2
from test_torch_port_model import _init

TOL = dict(rtol=1e-4, atol=1e-4)
CAM_TOL = 1e-4

FULL_WIDTH = {
    **{f"vit.{n}": (getattr(jvit, n), getattr(tvit, n), True) for n in (
        "vit_base_patch16_224", "vit_base_patch32_224",
        "vit_large_patch16_224", "vit_large_patch32_224",
        "vit_huge_patch14_224")},
    **{f"swin.{n}": (getattr(jswin, n), getattr(tswin, n), True) for n in (
        "swin_tiny_patch4_window7_224", "swin_small_patch4_window7_224",
        "swin_base_patch4_window7_224", "swin_large_patch4_window7_224")},
    "mobilenet.MobileNetV2": (jmob.MobileNetV2, tmob.MobileNetV2, False),
    "decoder.VSSMSeg": (functools.partial(jdec.VSSMSeg, scan_impl="seq"),
                        tdec.VSSMSeg, True),
}


def _jax_layout(key, shape):
    """A port parameter's shape in the JAX layout: Linear weights (out, in)
    -> (in, out), conv weights OIHW -> HWIO."""
    if key.endswith(".weight") and len(shape) == 2:
        return shape[::-1]
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_parameter_shapes_match_jax(name):
    jcls, tcls, third = FULL_WIDTH[name]
    jm = jcls()
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 224, 224, 3)), third),
        jax.random.key(0))
    want = {c: sorted(tuple(s.shape) for s in jax.tree_util.tree_leaves(
        shapes[c])) for c in shapes}
    with torch.device("meta"):
        tm = tcls()
    params = [_jax_layout(k, tuple(p.shape))
              for k, p in tm.named_parameters()]
    assert sorted(params) == want["params"]
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s)) for s in want["params"])
    stats = sorted(tuple(b.shape) for k, b in tm.state_dict().items()
                   if k.endswith(("running_mean", "running_var")))
    assert stats == want.get("batch_stats", [])


def _x(seed, size):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)) \
        .astype(np.float32)


class _Reads(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


SMALL = {
    "vit": (lambda: jvit.VisionTransformer(patch_size=8, embed_dim=32, depth=2,
                                           num_heads=2, num_classes=5),
            lambda: tvit.VisionTransformer(img_size=32, patch_size=8,
                                           embed_dim=32, depth=2, num_heads=2,
                                           num_classes=5),
            True, cb.vit_state_dict_from_jax, cb.vit_state_dict_to_jax,
            lambda sd: _vit_torch_to_flax(sd, 2)),
    "swin": (lambda: jswin.SwinTransformer(patch_size=4, embed_dim=16,
                                           depths=(2, 2), num_heads=(2, 4),
                                           window_size=4, num_classes=5),
             lambda: tswin.SwinTransformer(patch_size=4, embed_dim=16,
                                           depths=(2, 2), num_heads=(2, 4),
                                           window_size=4, num_classes=5),
             True, cb.swin_state_dict_from_jax, cb.swin_state_dict_to_jax,
             lambda sd: _swin_torch_to_flax(sd, (2, 2))),
    "mobilenet": (lambda: jmob.MobileNetV2(num_classes=5, alpha=0.35),
                  lambda: tmob.MobileNetV2(num_classes=5, alpha=0.35),
                  False, cb.mobilenet_state_dict_from_jax,
                  cb.mobilenet_state_dict_to_jax, _mnv2_torch_to_flax),
}


def _same_tree(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", sorted(SMALL))
def test_state_dict_matches_the_reference_schema_map(arch):
    jfac, tfac, third, from_jax, to_jax, ref_map = SMALL[arch]
    variables = _init(jfac(), _x(0, 32), 0, third)
    sd = from_jax(variables)
    tm = tfac()
    tm.load_state_dict(sd, strict=True)
    reads = _Reads(tm.state_dict())
    want = ref_map(reads)
    assert reads.read == {k for k in reads
                          if not k.endswith("num_batches_tracked")}
    _same_tree(to_jax(tm.state_dict()), want)
    _same_tree(want, variables)


@pytest.mark.parametrize("arch", sorted(SMALL))
def test_round_trips_are_exact(arch):
    jfac, tfac, third, from_jax, to_jax, _ = SMALL[arch]
    variables = _init(jfac(), _x(1, 32), 1, third)
    _same_tree(to_jax(from_jax(variables)), variables)
    sd = tfac().state_dict()
    back = from_jax(to_jax(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())


IMAGE = 64
CLI = {
    "vit": (jvit.vit_base_patch16_224, True, ("blocks_11", "norm1"),
            functools.partial(jvit.vit_reshape_transform, grid=IMAGE // 16),
            cb.vit_state_dict_from_jax),
    "swin": (jswin.swin_tiny_patch4_window7_224, True, ("norm",), None,
             cb.swin_state_dict_from_jax),
    "mobilenet": (_EvalMobileNetV2, False, ("head_conv", "conv"), None,
                  cb.mobilenet_state_dict_from_jax),
}


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("cam") / "x.png"
    path.write_bytes(png.encode(img))
    return img, str(path)


@pytest.mark.parametrize("arch", sorted(CLI))
def test_cli_matches_jax_grad_cam(arch, image, tmp_path):
    factory, third, path, reshape, from_jax = CLI[arch]
    img, img_path = image
    jm = factory(num_classes=10)
    x = jax_preprocess(jax.random.key(0), jnp.asarray(img[None]), size=IMAGE,
                       augment=False)
    variables = _init(jm, np.asarray(x), 3, third)
    pth = tmp_path / "w.pth"
    torch.save({"model_state_dict": from_jax(variables)}, pth)
    out = tmp_path / "cam.png"
    got = cam_backbones.main(["--arch", arch, "--image", img_path,
                              "--checkpoint_path", str(pth),
                              "--num_classes", "10", "--image_size",
                              str(IMAGE), "--output", str(out),
                              "--device", "cpu"])

    logits = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, True))(
        variables, x))[0]
    np.testing.assert_allclose(got["logits"], logits, **TOL)
    assert got["pred"] == got["target"] == int(logits.argmax())
    cam = jg.grad_cam(jm, variables, x, target_class=np.array([got["pred"]]),
                      target_path=path, reshape_transform=reshape)[0]
    assert got["cam"].shape == (IMAGE, IMAGE)
    np.testing.assert_allclose(got["cam"], cam, rtol=0, atol=CAM_TOL)
    assert cam.max() - cam.min() > 0.5
    written = png.decode(out.read_bytes())
    assert written.shape == (IMAGE, 2 * IMAGE, 3)
    np.testing.assert_array_equal(written[:, :IMAGE], img)


def test_cli_random_init_and_target_category(image, tmp_path):
    _, img_path = image
    out = tmp_path / "cam.png"
    got = cam_backbones.main(["--arch", "mobilenet", "--image", img_path,
                              "--random-ok", "--image_size", str(IMAGE),
                              "--target_category", "3", "--output", str(out),
                              "--device", "cpu"])
    assert got["target"] == 3 and got["logits"].shape == (1000,)
    assert np.isfinite(got["cam"]).all()
    assert 0.0 <= got["cam"].min() and got["cam"].max() <= 1.0
    assert png.decode(out.read_bytes()).shape == (IMAGE, 2 * IMAGE, 3)


def test_cli_needs_weights_and_a_card_unless_told(image, tmp_path):
    _, img_path = image
    with pytest.raises(SystemExit, match="--random-ok"):
        cam_backbones.main(["--arch", "vit", "--image", img_path,
                            "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cam_backbones.main(["--arch", "vit", "--image", img_path,
                                "--random-ok",
                                "--output", str(tmp_path / "c.png")])
