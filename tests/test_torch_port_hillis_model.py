"""One SS2D on the doubling scan against the JAX package's, on the CPU.

The JAX SS2D runs ``scan_impl="pallas"`` with ``MEDMAMBA_SCAN_KERNEL=hillis``
(its doubling kernels in Pallas interpret mode). On the port's side the
test routes the SS2D's scan through ``_hillis_scan`` with the plain versions
of K3 and K4 passed in; the port itself runs K3/K4 only on a CUDA tensor. A
logits-only comparison would prove little (a freshly drawn small VSSM gives
the same logits whatever its scan), so this compares one SS2D's output and
the gradients of its input and every parameter. At 12x12 (L = 144) the JAX
SS2D pads to 256 and scans with valid_len, so its last chunk is masked.
float32 agrees to 1e-4 of each output's largest entry. bfloat16 blocks
agree to 3e-2, the tolerance of the port's bf16 model tests (both round to
bfloat16 at the same layers but accumulate in other orders): the output and
the input gradient relative to their own largest entry, each parameter
gradient relative to the largest parameter gradient. A bf16 gradient's
rounding error scales with the activations it sums, not with the sum, which
may cancel: with both sides on their sequential scans ``conv2d.bias`` is
4.2e-2 of its own scale (2.0e-2 of the largest) at this seed, exactly as
here. The bf16 case also covers the SS2D's cast of the scan's float32 y to
the block dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.models import vssm as jv
from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.ops import selective_scan as ts
from test_torch_port_model import BLOCK, BLOCK_KEY, _block_state_dict, _init

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PATH = BLOCK + ("self_attention",)
PREFIX = BLOCK_KEY + "self_attention."


def _routed(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=False,
            return_last_state=False, impl="auto", reverse_dirs=None,
            tau=None, u_tile=1, out_dtype=None, valid_len=None):
    return ts._hillis_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                           return_last_state, reverse_dirs, u_tile,
                           valid_len, ts.selective_scan_hillis_ref,
                           ts.selective_scan_hillis_bwd_ref)


def _rel_err(got, want, scale=None) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    if scale is None:
        scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / max(scale, 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ss2d_forward_and_gradients_match_jax(monkeypatch, dtype):
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "hillis")
    monkeypatch.setattr(tv, "selective_scan", _routed)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 12, 12, 16)).astype(np.float32)
    jm = jv.SS2D(d_model=16, scan_impl="pallas", dtype=getattr(jnp, dtype))
    variables = _init(jm, x, 12)
    out_j = jm.apply(variables, jnp.asarray(x))
    gout = rng.standard_normal(out_j.shape).astype(np.float32)

    def loss(params, inp):
        out = jm.apply({"params": params}, inp)
        return jnp.sum(out.astype(jnp.float32) * gout)
    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x))

    tm = tv.SS2D(16, dtype=getattr(torch, dtype),
                 generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(_block_state_dict(variables, PATH, PREFIX),
                       strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    assert out.dtype == getattr(torch, dtype)
    out.float().backward(torch.from_numpy(gout))

    tol = TOL[dtype]
    errs = {"out": _rel_err(out.detach().float(),
                            jnp.asarray(out_j, jnp.float32)),
            "x": _rel_err(xt.grad, gx)}
    want = _block_state_dict({"params": gp}, PATH, PREFIX)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        errs[name] = _rel_err(named[name].grad, w.numpy(),
                              top if dtype == "bfloat16" else None)
    bad = {k: v for k, v in errs.items() if v > tol}
    assert not bad, bad
