"""The port's scan gradients and tile-entry states against the JAX package's.

The same numpy inputs and cotangent go through ``jax.grad`` of
``medmamba_tpu.ops.selective_scan.selective_scan(..., impl="seq")`` (the JAX
package's plain reference) and through the port: autograd through its plain
scan, and ``selective_scan_bwd_ref``, the explicit adjoint that is K2's plain
version. float32 gradients agree to 1e-5, relative to each gradient's
largest entry (they are sums over up to L * b products).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from medmamba_tpu.ops.selective_scan import selective_scan_seq
from medmamba_tpu_torch.ops import cuda_build, scan_cuda, scan_hillis
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


def _constants(source: str, name: str) -> list:
    """The values of ``constexpr int <name>`` in a ``csrc/`` source and the
    local headers it includes."""
    text = ""
    for f in cuda_build.source_files(source):
        with open(os.path.join(cuda_build.CSRC, f)) as fh:
            text += fh.read()
    return re.findall(rf"constexpr int {name} = (\d+);", text)


def test_k1_and_k2_share_the_tile():
    """K2 recomputes each tile from the state K1 saved at its entry, so both
    kernels' tile (``kT`` in their sources) is the wrapper's ``TILE``, the
    64 steps whose entry states the test above holds."""
    assert scan_cuda.TILE == 64
    for source in (scan_cuda.FWD_SOURCE, scan_cuda.BWD_SOURCE):
        tiles = _constants(source, "kT")
        assert tiles == [str(scan_cuda.TILE)], (source, tiles)


def test_k3_and_k4_share_the_chunk_and_k4_walks_k2s_tile():
    """K4 starts from the state K3 saved at each chunk's entry, so K3's
    chunk and K4's (``kChunk`` in both) are the wrapper's ``CHUNK``. K3 runs
    K1's walk and saves the state entering every other tile; K4 expands the
    chunk states to the entry states of K2's tiles and runs K2's walk. So
    the walk's tile in both builds is ``TILE`` and a chunk is two tiles."""
    assert scan_hillis.CHUNK == 128
    for source in (scan_hillis.FWD_SOURCE, scan_hillis.BWD_SOURCE):
        assert _constants(source, "kChunk") == [str(scan_hillis.CHUNK)]
        assert _constants(source, "kT") == [str(scan_cuda.TILE)]
    assert scan_hillis.CHUNK == 2 * scan_cuda.TILE
    # K2 and K4 build the same walk
    walk = set(cuda_build.source_files(scan_cuda.BWD_SOURCE)[1:])
    assert walk and walk <= set(cuda_build.source_files(scan_hillis.BWD_SOURCE))


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    """The build key covers the local headers a source includes, directly or
    through another header, so an edit to a shared header never loads a
    library built from the old one; other files do not move it."""
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    files = {"k.cu": '#include <cuda_runtime.h>\n#include "walk.cuh"\n',
             "walk.cuh": '#pragma once\n  #  include "inner.cuh"\n',
             "inner.cuh": "constexpr int kT = 64;\n",
             "other.cuh": "constexpr int kT = 32;\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    assert cuda_build.source_files("k.cu") == ["k.cu", "walk.cuh",
                                               "inner.cuh"]
    first = cuda_build.library_path("k.cu")
    (tmp_path / "other.cuh").write_text("constexpr int kT = 16;\n")
    assert cuda_build.library_path("k.cu") == first
    (tmp_path / "inner.cuh").write_text("constexpr int kT = 128;\n")
    second = cuda_build.library_path("k.cu")
    assert second != first
    (tmp_path / "walk.cuh").write_text('#include "inner.cuh"\n')
    assert cuda_build.library_path("k.cu") not in (first, second)


def _plain_k1(u, delta, A, B, C, D, delta_bias, *, delta_softplus,
              reverse_dirs, u_tile, out_dtype, valid_len, return_last_state,
              return_states, compute):
    """``scan_cuda.selective_scan_fwd`` computed by the plain versions."""
    from medmamba_tpu_torch.ops import selective_scan as ts
    with torch.no_grad():
        y, last = ts._plain_scan(u, delta, A, B, C, D, delta_bias,
                                 delta_softplus, True, reverse_dirs, u_tile,
                                 out_dtype, valid_len, compute)
        states = selective_scan_states_ref(
            u, delta, A, B, C, delta_bias, delta_softplus, reverse_dirs,
            u_tile, valid_len, compute) if return_states else None
    return y, last if return_last_state else None, states


def _kernel_function(kind, args):
    """(y, last) of ``_KernelScan`` (K1/K2) or ``_HillisScan`` (K3/K4) on
    CPU tensors, the kernels' plain versions in their places."""
    from medmamba_tpu_torch.ops import selective_scan as ts
    if kind == "ssd":
        kw = dict(delta_softplus=True, reverse_dirs=None, u_tile=1,
                  out_dtype=None, valid_len=None, compute="float32")
        return ts._KernelScan.apply(*args, True, kw)
    return ts._HillisScan.apply(*args, True, None,
                                ts.selective_scan_hillis_ref,
                                ts.selective_scan_hillis_bwd_ref, "float32")


@pytest.mark.parametrize("kind", ["ssd", "hillis"])
def test_kernel_scans_refuse_a_gradient_through_the_last_state(kind,
                                                               monkeypatch):
    """On the card a loss that used the last state lost its gradient there
    without a word (the state was marked non-differentiable); the kernel
    path now raises, as the JAX kernels cannot differentiate it. A
    gradient through y alone is unchanged: the plain scan's, 1e-5."""
    monkeypatch.setattr(scan_cuda, "selective_scan_fwd", _plain_k1)
    monkeypatch.setattr(scan_cuda, "selective_scan_bwd",
                        selective_scan_bwd_ref)
    x = _inputs(11, g=2, dpg=4, l=L)
    gy = torch.from_numpy(np.random.default_rng(12).standard_normal(
        x["delta"].shape).astype(np.float32))

    def leaves():
        return [torch.from_numpy(x[k]).requires_grad_() for k in NAMES]

    args = leaves()
    y, last = _kernel_function(kind, args)
    with pytest.raises(RuntimeError, match="last state"):
        ((y * gy).sum() + last.sum()).backward()

    args = leaves()
    y, last = _kernel_function(kind, args)
    (y * gy).sum().backward()
    want = leaves()
    (selective_scan(*want, delta_softplus=True, impl="ref") * gy
     ).sum().backward()
    for name, got, ref in zip(NAMES, args, want):
        _close(got.grad, ref.grad)
