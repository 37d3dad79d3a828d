"""The port's scan gradients and tile-entry states against the JAX package's.

The same numpy inputs and cotangent go through ``jax.grad`` of
``medmamba_tpu.ops.selective_scan.selective_scan(..., impl="seq")`` (the JAX
package's plain reference) and through the port: autograd through its plain
scan, and ``selective_scan_bwd_ref``, the explicit adjoint that is K2's plain
version. float32 gradients agree to 1e-5, relative to each gradient's
largest entry (they are sums over up to L * b products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from medmamba_tpu.ops.selective_scan import selective_scan_seq
from medmamba_tpu_torch.ops.selective_scan import (_tile_starts,
                                                   selective_scan,
                                                   selective_scan_bwd_ref,
                                                   selective_scan_states_ref)
from test_torch_port_scan import (  # noqa: F401
    CONTRACT_CASES, _inputs, _settle_torch_exp)

NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")
TOL = 1e-5
# 150 steps: three 64-step tiles, the last one short
L = 150


def _case(name):
    kw = dict(CONTRACT_CASES[name])
    kw.pop("return_last_state", None)
    g = kw.pop("groups", 2)
    if "valid_len" in kw:
        kw["valid_len"] += L - 24      # the cases were written for L = 24
    x = _inputs(7, g=g, dpg=8 // g, l=L, u_tile=kw.get("u_tile", 1))
    gy = np.random.default_rng(8).standard_normal(
        x["delta"].shape).astype(np.float32)
    return x, gy, kw


def _jax_grads(x, gy, kw):
    def loss(*args):
        y = jax_scan(*args, delta_softplus=True, impl="seq", **kw)
        return jnp.sum(y * gy)
    return jax.grad(loss, argnums=tuple(range(7)))(
        *(jnp.asarray(x[k]) for k in NAMES))


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= TOL, err


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_scan_gradients_match_jax(case):
    x, gy, kw = _case(case)
    want = _jax_grads(x, gy, kw)
    xt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in x.items()}
    y = selective_scan(*(xt[k] for k in NAMES), delta_softplus=True, **kw)
    y.backward(torch.from_numpy(gy))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    states = selective_scan_states_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["delta_bias"], True,
        kw.get("reverse_dirs"), kw.get("u_tile", 1), kw.get("valid_len"))
    adjoint = selective_scan_bwd_ref(*(t[k] for k in NAMES), states,
                                     torch.from_numpy(gy),
                                     delta_softplus=True, **kw)
    for name, w, a in zip(NAMES, want, adjoint):
        assert a.dtype == t[name].dtype and a.shape == t[name].shape
        _close(xt[name].grad.numpy(), w)
        _close(a.numpy(), w)


def test_bwd_ref_without_skip_or_softplus():
    """D and delta_bias absent (their gradients None), delta used as dt."""
    x, gy, _ = _case("forward")
    x = {k: v for k, v in x.items() if k not in ("D", "delta_bias")}
    x["delta"] = np.abs(x["delta"])

    def loss(*args):
        return jnp.sum(jax_scan(*args, delta_softplus=False, impl="seq") * gy)
    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(x[k]) for k in NAMES[:5]))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    states = selective_scan_states_ref(t["u"], t["delta"], t["A"], t["B"],
                                       t["C"])
    got = selective_scan_bwd_ref(t["u"], t["delta"], t["A"], t["B"], t["C"],
                                 None, None, states, torch.from_numpy(gy))
    assert got[5] is None and got[6] is None
    for g, w in zip(got[:5], want):
        _close(g.numpy(), w)


def test_bwd_ref_bf16_inputs_give_bf16_grads():
    """The gradients take their primals' dtypes, as the JAX custom_vjp's:
    du, ddelta, dB and dC bfloat16; dA, dD and dbias float32."""
    x, gy, _ = _case("reverse")
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    for k in ("u", "delta", "B", "C"):
        t[k] = t[k].bfloat16()
    states = selective_scan_states_ref(t["u"], t["delta"], t["A"], t["B"],
                                       t["C"], t["delta_bias"], True,
                                       (True, True))
    got = selective_scan_bwd_ref(*(t[k] for k in NAMES), states,
                                 torch.from_numpy(gy).bfloat16(),
                                 delta_softplus=True,
                                 reverse_dirs=(True, True))
    assert [g.dtype for g in got] == [torch.bfloat16] * 2 + [torch.float32] \
        + [torch.bfloat16] * 2 + [torch.float32] * 2


@pytest.mark.parametrize("case", ["forward", "reverse", "mixed_prefix_suffix",
                                  "four_groups_interleaved", "u_tile"])
def test_states_ref_matches_jax_prefix_scans(case):
    """The state at the entry of tile k of a group is the last state of the
    JAX scan over the steps that group processed before it."""
    x, _, kw = _case(case)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    states = selective_scan_states_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], t["delta_bias"], True,
        kw.get("reverse_dirs"), kw.get("u_tile", 1),
        kw.get("valid_len")).numpy()
    g = x["B"].shape[1]
    d = x["delta"].shape[1]
    dpg = d // g
    assert states.shape == (2, d, -(-L // 64), 16)
    u = np.concatenate([x["u"]] * kw.get("u_tile", 1), axis=1)
    delta = x["delta"].copy()
    if "valid_len" in kw:
        delta[..., kw["valid_len"]:] = -1e4        # dt = 0 there
    rev = kw.get("reverse_dirs") or (False,) * g
    for k in range(g):
        ch = slice(k * dpg, (k + 1) * dpg)
        seq = [u[:, ch], delta[:, ch], x["B"][:, k:k + 1],
               x["C"][:, k:k + 1]]
        if rev[k]:
            seq = [a[..., ::-1] for a in seq]
        for tile, j in enumerate(_tile_starts(L, rev[k])):
            if j == 0:
                np.testing.assert_array_equal(states[:, ch, tile], 0.0)
                continue
            _, last = selective_scan_seq(
                *(jnp.asarray(np.ascontiguousarray(a[..., :j])) for a in seq[:2]),
                jnp.asarray(x["A"][ch]),
                *(jnp.asarray(np.ascontiguousarray(a[..., :j])) for a in seq[2:]),
                delta_bias=jnp.asarray(x["delta_bias"][ch]),
                delta_softplus=True, return_last_state=True)
            np.testing.assert_allclose(states[:, ch, tile], np.asarray(last),
                                       rtol=TOL, atol=TOL)
