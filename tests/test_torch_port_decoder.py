"""The port's segmentation U-net (``models/decoder.py``) against the JAX
package's, on the CPU.

``PatchExpand2D`` and ``FinalPatchExpand2D``, then a tiny ``VSSMSeg`` (the
sizes of ``tests/test_decoder.py``: depths (1, 1) both ways, dims (8, 16),
d_state 4, 32^2), its JAX variables drawn with numpy from their shapes and
carried across with ``state_dict_from_jax``; the JAX side scans with
``selective_scan_seq``, the port's with its plain scan (a CPU tensor never
reaches the kernels). Outputs agree to 1e-4; every parameter's gradient
within 1e-4 of its scale (its largest entry: a gradient sums over pixels
and channels, and an entry far below the scale keeps only the float32
rounding of the sum), the rule ``chip_smoke.py`` holds K2's gradients to.

At these widths the final x4 expansion leaves 8 / 4 = 2 channels for its
LayerNorm, and flax's LayerNorm takes the variance as E[x^2] - E[x]^2
(``use_fast_variance``), which loses up to 3.4e-4 of the output in float32
where the two channels nearly agree; torch's LayerNorm does not. So the
whole net is held against the JAX module evaluated in float64
(``jax.enable_x64``), the exact value both float32 programs approximate;
its float32 evaluation is held to 1e-4 up to that LayerNorm's input.
"""
import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from medmamba_tpu.models import decoder as jdec
from medmamba_tpu_torch.models import decoder as tdec
from medmamba_tpu_torch.utils.convert import (state_dict_from_jax,
                                              state_dict_to_jax)
from test_torch_port_model import _block_state_dict, _init, _x
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(num_classes=3, depths=(1, 1), depths_decoder=(1, 1), dims=(8, 16),
            d_state=4)


@pytest.mark.parametrize("final", [False, True], ids=["x2", "x4"])
def test_patch_expand_matches_jax(final):
    x = _x(0, (2, 3, 5, 16))
    jm = jdec.FinalPatchExpand2D() if final else jdec.PatchExpand2D()
    variables = _init(jm, x, 0)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    path = ("final_up",) if final else ("layers_up_1", "upsample")
    tm = (tdec.FinalPatchExpand2D if final else tdec.PatchExpand2D)(
        16, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(_block_state_dict(
        variables, path, "final_up." if final else "layers_up.1.upsample."),
        strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((2, 12, 20, 4) if final
                                       else (2, 6, 10, 8))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def seg():
    x = _x(1, (2, 32, 32, 3))
    jm = jdec.VSSMSeg(**TINY, scan_impl="seq")
    variables = _init(jm, x, 1, True)
    tm = tdec.VSSMSeg(**TINY)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm.eval(), x


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_output_matches_jax(seg):
    jm, variables, tm, x = seg
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, True))(
            _f64(variables), jnp.asarray(x, jnp.float64)))
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)

    # float32 JAX, up to the final expansion's LayerNorm
    def forward(v, a):
        cell = {}

        def capture(next_fn, args, kwargs, context):
            out = next_fn(*args, **kwargs)
            cell[context.module.path] = out
            return out
        with nn.intercept_methods(capture):
            jm.apply(v, a, True)
        return cell[("layers_up_1",)], cell[("final_up", "expand")]
    want_up, want_expand = jax.jit(forward)(variables, jnp.asarray(x))
    acts = {}
    hooks = [tm.get_submodule(name).register_forward_hook(
        lambda m, i, o, name=name: acts.__setitem__(name, o))
        for name in ("layers_up.1", "final_up.expand")]
    try:
        with torch.no_grad():
            tm(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    np.testing.assert_allclose(acts["layers_up.1"].numpy(),
                               np.asarray(want_up), **TOL)
    np.testing.assert_allclose(acts["final_up.expand"].numpy(),
                               np.asarray(want_expand), **TOL)


def test_gradients_match_jax(seg):
    """Of a weighted sum of the output (deterministic forward) with respect
    to every parameter, encoder and decoder."""
    jm, variables, tm, x = seg
    w = _x(2, (2, 32, 32, 3))
    with jax.enable_x64(True):
        v64 = _f64(variables)

        def loss_fn(params):
            out = jm.apply({"params": params,
                            "batch_stats": v64["batch_stats"]},
                           jnp.asarray(x, jnp.float64), True)
            return jnp.sum(out * jnp.asarray(w, jnp.float64))
        grads = jax.jit(jax.grad(loss_fn))(v64["params"])
        want = state_dict_from_jax({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), grads)})
    tm.zero_grad()
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    assert any(k.startswith("layers_up.1.blocks.0.self_attention")
               for k in named)
    for name, g in want.items():
        scale = g.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)
    tm.zero_grad()


def test_state_dict_round_trip_is_exact(seg):
    _, variables, tm, _ = seg
    back = state_dict_to_jax(tm.state_dict())
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables[coll]):
            g = back[coll]
            for p in path:
                g = g[p.key]
            np.testing.assert_array_equal(g, leaf)
    sd = state_dict_from_jax(back)
    assert sd.keys() == tm.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    assert {"layers_up.1.upsample.expand.weight",
            "layers_up.1.upsample.norm.weight", "final_up.expand.weight",
            "final_up.norm.bias", "head.weight", "head.bias",
            "layers_up.0.blocks.0.conv33conv33conv11.7.weight"} <= sd.keys()
    assert tuple(sd["head.weight"].shape) == (3, 2, 1, 1)


def test_forward_uses_the_port_scan_dispatcher(seg, monkeypatch):
    """Every SS-Conv-SSM block of encoder and decoder scans twice through
    ``selective_scan`` (K1 on the card): 2 x (1 + 1 + 1 + 1) calls."""
    from medmamba_tpu_torch.models import vssm

    _, _, tm, x = seg
    calls = []
    real = vssm.selective_scan
    monkeypatch.setattr(vssm, "selective_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert len(calls) == 8
