"""The port's whole VSSM against the JAX package's, on the CPU.

Variables are drawn as in ``test_torch_port_model.py`` and carried into the
port with ``state_dict_from_jax``. The JAX side scans with
``selective_scan_seq``; float32 logits agree to 1e-4.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from medmamba_tpu.models import vssm as jv
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.utils.convert import (state_dict_from_jax,
                                              state_dict_to_jax)
from test_torch_port_model import TOL, _init, _x


def _tiny_pair(x, seed):
    jm = jv.VSSM(num_classes=5, depths=(1, 1), dims=(16, 32), scan_impl="seq")
    variables = _init(jm, x, seed, True)
    tm = tv.VSSM(num_classes=5, depths=(1, 1), dims=(16, 32)).eval()
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("size", [32, 36, 48])
def test_vssm_logits_match_jax(size):
    """36: a 9x9 stage, cropped to 4x4 by PatchMerging. 48: a 12x12 stage
    (L = 144, padded by the JAX SS2D)."""
    x = _x(3, (2, size, size, 3))
    jm, variables, tm = _tiny_pair(x, 3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_forward_backbone_matches_jax():
    x = _x(4, (2, 32, 32, 3))
    jm, variables, tm = _tiny_pair(x, 4)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), True,
                               method=jv.VSSM.forward_backbone))
    with torch.no_grad():
        got = tm.forward_backbone(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_convert_round_trips():
    x = _x(5, (1, 32, 32, 3))
    _, variables, tm = _tiny_pair(x, 5)
    back = state_dict_to_jax(state_dict_from_jax(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    sd = tm.state_dict()
    again = state_dict_from_jax(state_dict_to_jax(sd))
    assert sd.keys() == again.keys()
    for k in sd:
        assert torch.equal(sd[k], again[k]), k
