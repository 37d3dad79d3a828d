"""The port's selective scan against the JAX package's, on the CPU.

The same numpy inputs go through ``medmamba_tpu.ops.selective_scan`` (the
sequential ``selective_scan_seq`` and the ``assoc`` dispatch path) and
through ``medmamba_tpu_torch.ops.selective_scan``. float32 agrees to 1e-5.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from medmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from medmamba_tpu.ops.selective_scan import selective_scan_seq
from medmamba_tpu_torch.ops import scan_cuda
from medmamba_tpu_torch.ops.selective_scan import (selective_scan,
                                                   selective_scan_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _settle_torch_exp():
    """Call ``torch.exp`` once before anything here is compared. Its first
    call in a process can come back inaccurate on the CPU: up to 1.1e-4 off
    on values in (0, 1], in 3 of 1000 fresh processes (torch 2.13,
    AVX-512), where later calls are within 1 ulp; after one call on other
    data, in none of 1000. The plain versions' decays then move y by up to
    4e-5 of its scale, over the 1e-5 that this module and the two that
    import this fixture for the scans (``test_torch_port_grad.py``,
    ``test_torch_port_hillis.py``) hold them to. The modules that hold a
    model's probabilities or loss to the JAX package's at 1e-5 or closer
    (``test_torch_port_demo.py``, ``_folder.py``, ``_train.py``) import
    it too."""
    torch.exp(torch.zeros(1024))


def _inputs(seed, b=2, g=2, dpg=4, n=16, l=24, u_tile=1):
    rng = np.random.default_rng(seed)
    d = g * dpg
    f32 = np.float32
    return dict(
        u=rng.standard_normal((b, d // u_tile, l)).astype(f32),
        delta=(0.5 * rng.standard_normal((b, d, l))).astype(f32),
        A=(-np.exp(0.5 * rng.standard_normal((d, n)))).astype(f32),
        B=rng.standard_normal((b, g, n, l)).astype(f32),
        C=rng.standard_normal((b, g, n, l)).astype(f32),
        D=rng.standard_normal((d,)).astype(f32),
        delta_bias=(0.1 * rng.standard_normal((d,))).astype(f32),
    )


def _jax(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


@pytest.mark.parametrize("groups,skip,softplus", [
    (1, True, True), (2, True, True), (4, False, True), (2, True, False)])
def test_ref_matches_jax_seq(groups, skip, softplus):
    x = _inputs(groups, g=groups, dpg=8 // groups)
    if not skip:
        x.pop("D")
        x.pop("delta_bias")
    y_j, h_j = selective_scan_seq(**_jax(x), delta_softplus=softplus,
                                  return_last_state=True)
    y_t, h_t = selective_scan_ref(**_torch(x), delta_softplus=softplus,
                                  return_last_state=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)


CONTRACT_CASES = {
    "forward": dict(),
    "reverse": dict(reverse_dirs=(True, True)),
    "mixed_prefix_suffix": dict(reverse_dirs=(False, True)),
    "reverse_valid_len": dict(reverse_dirs=(True, True), valid_len=17),
    "forward_valid_len": dict(valid_len=20),
    "u_tile": dict(u_tile=2, reverse_dirs=(False, True)),
    "last_state_reverse": dict(reverse_dirs=(True, False),
                               return_last_state=True),
    "four_groups_interleaved": dict(groups=4,
                                    reverse_dirs=(True, False, True, False),
                                    return_last_state=True, valid_len=21),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_dispatch_matches_jax_assoc(case):
    kw = dict(CONTRACT_CASES[case])
    g = kw.pop("groups", 2)
    x = _inputs(7, g=g, dpg=8 // g, u_tile=kw.get("u_tile", 1))
    out_j = jax_scan(**_jax(x), delta_softplus=True, impl="assoc", **kw)
    out_t = selective_scan(**_torch(x), delta_softplus=True, **kw)
    if kw.get("return_last_state"):
        np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                                   **TOL)
        out_j, out_t = out_j[0], out_t[0]
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_bf16_inputs_with_bf16_output():
    """bfloat16 u/delta/B/C in, bfloat16 y out. Both sides see the same
    bf16-rounded inputs; the only extra error is y's final rounding to bf16
    (8 bits of mantissa: relative 2^-8), so 1e-2 relative and absolute."""
    x = _inputs(11)
    for k in ("u", "delta", "B", "C"):
        x[k] = torch.from_numpy(x[k]).bfloat16().float().numpy()
    y_j = selective_scan_seq(**_jax(x), delta_softplus=True)
    xt = _torch(x)
    for k in ("u", "delta", "B", "C"):
        xt[k] = xt[k].bfloat16()
    y_t = selective_scan(**xt, delta_softplus=True, out_dtype=torch.bfloat16)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j),
                               rtol=1e-2, atol=1e-2)


def test_tau_is_accepted_and_ignored():
    x = _torch(_inputs(3))
    y0 = selective_scan(**x, delta_softplus=True)
    y1 = selective_scan(**x, delta_softplus=True, tau=64)
    assert torch.equal(y0, y1)


def test_cpu_call_leaves_launch_count_at_zero(monkeypatch):
    monkeypatch.setattr(scan_cuda, "LAUNCHES", 0)
    selective_scan(**_torch(_inputs(5)), delta_softplus=True,
                   reverse_dirs=(True, True))
    assert scan_cuda.LAUNCHES == 0


def test_cuda_impl_refuses_cpu_tensors():
    """The kernel's wrapper raises on a CPU tensor: nothing falls back."""
    with pytest.raises(ValueError, match="CUDA"):
        scan_cuda.selective_scan_fwd(**_torch(_inputs(5)),
                                     delta_softplus=True)


def test_valid_len_requires_softplus():
    with pytest.raises(ValueError, match="softplus"):
        selective_scan(**_torch(_inputs(5)), valid_len=10)
