"""The port's doubling scan (``MEDMAMBA_SCAN_KERNEL=hillis``) against the JAX
package's, on the CPU.

The JAX side runs its hillis kernels ``_fwd_kernel``/``_bwd_kernel`` in
Pallas interpret mode, with the variable set as
``tests/test_selective_scan.py`` sets it. The port's side runs the plain
versions of K3 and K4 (``selective_scan_hillis_ref``,
``selective_scan_hillis_bwd_ref``), and its wrapper ``_hillis_scan`` (flips,
masking, tiling, ``_HillisScan``) with those plain versions passed in: the
kernels themselves run only on the card (``test_torch_port_cuda.py``).
Inputs come from a numpy seed. float32 results agree to 1e-5 of each
output's largest entry (the two do the same doubling in float32; exp and
softplus come from two libraries); bfloat16 gradients to 1e-2 (their last
rounding, 2^-8 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.ops import pallas_scan as jps
from medmamba_tpu_torch.ops import scan_hillis
from medmamba_tpu_torch.ops import selective_scan as ts
from test_torch_port_scan import _inputs, _settle_torch_exp  # noqa: F401

NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")
LOW = ("u", "delta", "B", "C")         # the operands that may be bfloat16
TOL = 1e-5
TOL_BF16 = 1e-2


@pytest.fixture
def hillis(monkeypatch):
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "hillis")


def _case(seed, l, dtype="float32", b=2, g=2, dpg=4, u_tile=1):
    """numpy inputs (u, delta, B and C rounded to ``dtype``) and a cotangent
    of y's shape."""
    x = _inputs(seed, b=b, g=g, dpg=dpg, l=l, u_tile=u_tile)
    if dtype == "bfloat16":
        for k in LOW:
            x[k] = np.asarray(jnp.asarray(x[k], jnp.bfloat16))
    gy = np.random.default_rng(seed + 1).standard_normal(
        x["delta"].shape).astype(np.float32)
    return x, gy


def _jax(x):
    return [jnp.asarray(x[k]) for k in NAMES]


def _torch(x, grad=False):
    return [torch.from_numpy(np.asarray(x[k], np.float32))
            .to(torch.bfloat16 if x[k].dtype == jnp.bfloat16 else
                torch.float32).requires_grad_(grad) for k in NAMES]


def _close(got, want, tol=TOL, name=""):
    got = np.asarray(torch.as_tensor(got).float()) if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [49, 128, 200])
def test_ref_matches_jax_kernel(hillis, l, dtype):
    """L 49: one short chunk; 128: one whole chunk; 200: a masked last
    chunk. y, the chunk-entry states and the last state."""
    x, _ = _case(l, l, dtype)
    b, d, _ = x["delta"].shape
    g, n = x["B"].shape[1], x["A"].shape[1]
    u4, dt4, A3, B4, C4, D2, bias2, _, lp = jps._layout(
        *_jax(x), scan_hillis.CHUNK)
    y4, st, last = jps._fwd_pallas(u4, dt4, A3, B4, C4, D2, bias2,
                                   scan_hillis.CHUNK, l)
    y, states, h = ts.selective_scan_hillis_ref(*_torch(x),
                                                delta_softplus=True)
    assert y.dtype == states.dtype == h.dtype == torch.float32
    _close(y, np.asarray(y4).reshape(b, d, lp)[..., :l], name="y")
    st = np.asarray(st).transpose(0, 1, 3, 2, 4).reshape(b, d, -1, n)
    assert states.shape == (b, d, scan_hillis.n_chunks(l), n)
    _close(states, st, name="states")
    _close(h, np.asarray(last).reshape(b, d, n), name="last")


def _jax_grads(x, gy, **kw):
    def loss(*args):
        y = jps.selective_scan_pallas(*args, delta_softplus=True, **kw)
        return jnp.sum(y.astype(jnp.float32) * gy)
    return jax.grad(loss, argnums=tuple(range(7)))(*_jax(x))


@pytest.mark.parametrize("l,dtype", [(49, "float32"), (200, "float32"),
                                     (200, "bfloat16")])
def test_bwd_ref_matches_jax_grad(hillis, l, dtype):
    x, gy = _case(l + 3, l, dtype)
    want = _jax_grads(x, gy)
    args = _torch(x)
    _, states, _ = ts.selective_scan_hillis_ref(*args, delta_softplus=True)
    got = ts.selective_scan_hillis_bwd_ref(*args, states,
                                           torch.from_numpy(gy),
                                           delta_softplus=True)
    for name, a, gr, w in zip(NAMES, args, got, want):
        assert gr.dtype == a.dtype and gr.shape == a.shape, name
        _close(gr, w, TOL_BF16 if a.dtype == torch.bfloat16 else TOL, name)


def _port_scan(args, **kw):
    return ts._hillis_scan(
        *args, True, kw.get("return_last_state", False),
        kw.get("reverse_dirs"), kw.get("u_tile", 1), kw.get("valid_len"),
        ts.selective_scan_hillis_ref, ts.selective_scan_hillis_bwd_ref)


# L 256 where valid_len is given: the JAX wrapper takes arrays padded to the
# chunk then
WRAPPER_CASES = {
    "reverse": (200, dict(reverse_dirs=(True, True))),
    "mixed": (200, dict(reverse_dirs=(False, True))),
    "u_tile": (200, dict(u_tile=2, reverse_dirs=(False, True))),
    "valid_len_reverse": (256, dict(reverse_dirs=(True, True),
                                    valid_len=200)),
    "valid_len_forward": (256, dict(valid_len=200)),
    "out_dtype_bf16": (200, dict(reverse_dirs=(False, True),
                                 out_dtype="bfloat16")),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_wrapper_matches_jax(hillis, case):
    l, kw = WRAPPER_CASES[case]
    kw = dict(kw)
    x, gy = _case(11, l, u_tile=kw.get("u_tile", 1))
    jkw = dict(kw)
    if "out_dtype" in kw:
        jkw["out_dtype"] = jnp.bfloat16
        kw["out_dtype"] = torch.bfloat16
    y_j = jps.selective_scan_pallas(*_jax(x), delta_softplus=True, **jkw)
    want = _jax_grads(x, gy, **jkw)
    args = _torch(x, grad=True)
    y = _port_scan(args, **kw)
    # the doubling kernels store y in float32 whatever out_dtype asks
    assert y.dtype == torch.float32 and y_j.dtype == jnp.float32
    _close(y.detach(), y_j, name="y")
    y.backward(torch.from_numpy(gy))
    for name, a, w in zip(NAMES, args, want):
        _close(a.grad, w, name=name)


def test_wrapper_last_state_of_a_reverse_group(hillis):
    """A flagged group's last state is the state after buffer position 0,
    as the sequential scan on the flipped sequence gives it."""
    x, _ = _case(5, 150)
    kw = dict(reverse_dirs=(True, False), return_last_state=True)
    y, last = _port_scan(_torch(x), **kw)
    y_s, last_s = ts.selective_scan(*_torch(x), delta_softplus=True, **kw)
    _close(y, y_s, name="y")
    _close(last, last_s, name="last")


def test_kernel_selector(monkeypatch):
    """Read at each call: unset is ``ssd``; an unknown value raises; on a
    CPU tensor either value runs the plain sequential scan."""
    monkeypatch.delenv("MEDMAMBA_SCAN_KERNEL", raising=False)
    assert ts._kernel_impl() == "ssd"
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "hillis")
    assert ts._kernel_impl() == "hillis"
    x, _ = _case(3, 40)
    y_h = ts.selective_scan(*_torch(x), delta_softplus=True)
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "ssd")
    y_s = ts.selective_scan(*_torch(x), delta_softplus=True)
    assert torch.equal(y_h, y_s)
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "doubling")
    with pytest.raises(ValueError, match="MEDMAMBA_SCAN_KERNEL"):
        ts._kernel_impl()


def test_launchers_refuse_cpu_tensors():
    x, gy = _case(4, 40)
    args = _torch(x)
    with pytest.raises(ValueError, match="CUDA"):
        scan_hillis.selective_scan_hillis_fwd(*args, delta_softplus=True)
    states = torch.zeros(2, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        scan_hillis.selective_scan_hillis_bwd(*args, states,
                                              torch.from_numpy(gy))
