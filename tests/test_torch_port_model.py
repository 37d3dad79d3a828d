"""The port's VSSM and its parts against the JAX package's, on the CPU.

JAX variables are drawn with numpy at the shapes of the JAX module (so that
BatchNorm statistics, LayerNorm affines and biases are not identities),
carried into the port with ``state_dict_from_jax`` and fed the same numpy
input. The JAX side scans with ``selective_scan_seq``. float32 outputs
agree to 1e-4, the tolerance of ``tests/test_torch_parity.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from medmamba_tpu.models import registry as jreg
from medmamba_tpu.models import vssm as jv
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.models.registry import create_model
from medmamba_tpu_torch.utils.convert import (state_dict_from_jax,
                                              state_dict_to_jax)

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = ("layers_0", "blocks_0")
BLOCK_KEY = "layers.0.blocks.0."


def _fill(shape_tree, rng):
    """Random variables for a JAX module from its shapes alone (no init
    compile): BatchNorm variances positive, scales and skips near 1, A_logs
    near the S4D init log(1..N), everything else small noise."""
    out = {}
    for k, v in shape_tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng)
            continue
        noise = 0.1 * rng.standard_normal(v.shape)
        if k == "var":
            val = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("scale", "Ds"):
            val = 1.0 + noise
        elif k == "A_logs":
            val = np.log(np.arange(1, v.shape[-1] + 1)) + noise
        else:
            val = noise
        out[k] = val.astype(np.float32)
    return out


def _init(module, x, seed, *args):
    shapes = jax.eval_shape(lambda k, v: module.init(k, v, *args),
                            jax.random.key(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return {c: _fill(dict(shapes[c]), rng)
            for c in ("params", "batch_stats") if c in shapes}


def _nest(tree, path):
    for k in reversed(path):
        tree = {k: tree}
    return tree


def _block_state_dict(variables, path, prefix):
    """Port state dict of a submodule: its JAX variables placed at ``path``
    of a whole model, converted, and the ``prefix`` taken off the keys."""
    nested = {c: _nest(v, path) for c, v in variables.items()}
    return {k[len(prefix):]: v for k, v in state_dict_from_jax(nested).items()}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 6, 8), (1, 12, 12, 8)])
def test_ss2d_matches_jax(shape):
    """(1, 12, 12, 8): L = 144, which the JAX SS2D pads to 256 and scans with
    valid_len; the port scans L = 144 unpadded."""
    x = _x(0, shape)
    jm = jv.SS2D(d_model=8, scan_impl="seq")
    variables = _init(jm, x, 0)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = tv.SS2D(8, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(_block_state_dict(
        variables, BLOCK + ("self_attention",),
        BLOCK_KEY + "self_attention."), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_ssconvssm_eval_matches_jax():
    x = _x(1, (2, 6, 5, 16))
    jm = jv.SSConvSSM(hidden_dim=16, scan_impl="seq")
    variables = _init(jm, x, 1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), True))
    tm = tv.SSConvSSM(16, generator=torch.Generator().manual_seed(0)).eval()
    tm.load_state_dict(_block_state_dict(variables, BLOCK, BLOCK_KEY),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_ssconvssm_train_mode_masked_batchnorm_matches_jax():
    """Train mode: BatchNorm statistics over the rows the mask keeps, and
    the running statistics updated as flax's BatchNorm(momentum=0.9)."""
    x = _x(2, (3, 4, 4, 16))
    mask = np.array([True, True, False])
    jm = jv.SSConvSSM(hidden_dim=16, scan_impl="seq")
    variables = _init(jm, x, 2)
    want, upd = jm.apply(variables, jnp.asarray(x), False, jnp.asarray(mask),
                         mutable=["batch_stats"])
    tm = tv.SSConvSSM(16, generator=torch.Generator().manual_seed(0)).train()
    tm.load_state_dict(_block_state_dict(variables, BLOCK, BLOCK_KEY),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    new_stats = state_dict_to_jax(
        {BLOCK_KEY + k: v for k, v in tm.state_dict().items()})["batch_stats"]
    for name, stats in upd["batch_stats"].items():
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(new_stats[BLOCK[0]][BLOCK[1]][name][leaf],
                                       np.asarray(stats[leaf]), **TOL)


def test_medmamba_t_parameters_and_state_dict_schema():
    """14,459,529 parameters at 9 classes (docs/DESIGN.md:539), and exactly
    the keys and shapes that state_dict_from_jax makes of the JAX model's
    variables (shapes from jax.eval_shape: nothing is computed)."""
    model = create_model("T", 9, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 14_459_529
    shapes = jax.eval_shape(jreg.create_model("T", 9, scan_impl="seq").init,
                            jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(shapes))
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(zeros).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_inits_are_reproducible_from_the_generator():
    a = tv.VSSM(num_classes=3, depths=(1, 1), dims=(16, 32),
                generator=torch.Generator().manual_seed(7))
    b = tv.VSSM(num_classes=3, depths=(1, 1), dims=(16, 32),
                generator=torch.Generator().manual_seed(7))
    c = tv.VSSM(num_classes=3, depths=(1, 1), dims=(16, 32),
                generator=torch.Generator().manual_seed(8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["head.weight"], sc["head.weight"])
    w = a.state_dict()["layers.0.blocks.0.self_attention.in_proj.weight"]
    assert w.abs().max() <= 0.04 / 0.87962566103423978 + 1e-6
