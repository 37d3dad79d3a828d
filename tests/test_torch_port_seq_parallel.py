"""The port's sequence-parallel scan (``ops/seq_parallel.py``) against the
JAX package's, on the CPU.

L is split over 2 and 4 gloo ranks (``torch_port_ranks.spawn``); the JAX
side splits it over its 8-device virtual mesh (``impl="assoc"``) and scans
it whole (``selective_scan_assoc``), on the inputs of
``tests/test_seq_parallel.py``. y and the final state within 1e-5 of their
scale, with ``impl="ref"`` and ``"auto"`` (the plain scan on a CPU tensor);
the gradients of sum(y^2) through the stitch and the all-gather
(``impl="ref"``) within 1e-4 of each one's scale, the JAX test's bound; and
the case whose decays underflow to 0 along the sequence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_ranks as ranks
from medmamba_tpu.ops.selective_scan import selective_scan_assoc
from medmamba_tpu.ops.seq_parallel import \
    selective_scan_seq_parallel as jax_seq_parallel
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

NAMES = ("u", "delta", "A", "B", "C", "D", "bias")
WORLDS = (2, 4)


def _mk(seed, b=2, d=8, n=4, l=128, g=2):
    rng = np.random.default_rng(seed)
    return dict(
        u=rng.standard_normal((b, d, l)).astype(np.float32),
        delta=(0.3 * rng.standard_normal((b, d, l))).astype(np.float32),
        A=-np.exp(rng.standard_normal((d, n)).astype(np.float32) * 0.5),
        B=rng.standard_normal((b, g, n, l)).astype(np.float32),
        C=rng.standard_normal((b, g, n, l)).astype(np.float32),
        D=rng.standard_normal((d,)).astype(np.float32),
        bias=(0.1 * rng.standard_normal((d,))).astype(np.float32))


def _underflow():
    """Strong decay over a long sequence: the decay products vanish."""
    x = _mk(2, l=512)
    x["delta"] = np.abs(x["delta"]) + 2.0
    x["A"] = x["A"] * 10.0
    return x


CASES = {"scan": _mk(0), "grads": _mk(1, l=64), "underflow": _underflow()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Per world size, each rank's results for every case."""
    cases = [{k: torch.from_numpy(v) for k, v in x.items()}
             for x in CASES.values()]
    out = {}
    for world in WORLDS:
        got = ranks.spawn(ranks.seq_scan, world,
                          tmp_path_factory.mktemp(f"seq{world}"), cases)
        out[world] = {name: [g[i] for g in got]
                      for i, name in enumerate(CASES)}
    return out


def _jax_split(x, fn):
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("seq",))
    sh = NamedSharding(mesh, P(None, None, "seq"))
    sh4 = NamedSharding(mesh, P(None, None, None, "seq"))
    args = tuple(jax.device_put(x[k], sh) if k in ("u", "delta") else
                 jax.device_put(x[k], sh4) if k in ("B", "C") else
                 jnp.asarray(x[k]) for k in NAMES)
    return jax.jit(lambda a: fn(a, mesh))(args)


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, err


@pytest.mark.parametrize("case", ["scan", "underflow"])
@pytest.mark.parametrize("world", WORLDS)
def test_forward_and_final_state_match_jax(port, world, case):
    x = CASES[case]
    y_split, h_split = _jax_split(x, lambda a, mesh: jax_seq_parallel(
        *a[:6], delta_bias=a[6], delta_softplus=True, mesh=mesh,
        seq_axis="seq", impl="assoc", return_last_state=True))
    y_whole, h_whole = selective_scan_assoc(
        *(jnp.asarray(x[k]) for k in NAMES[:6]),
        delta_bias=jnp.asarray(x["bias"]), delta_softplus=True,
        return_last_state=True)
    for impl in ("ref", "auto"):
        y = torch.cat([r[f"y_{impl}"] for r in port[world][case]], dim=-1)
        for want in (y_split, y_whole):
            _close(y, want, 1e-5)
        for r in port[world][case]:
            for want in (h_split, h_whole):
                _close(r[f"h_{impl}"], want, 1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_ref_gradients_match_jax(port, world):
    x = CASES["grads"]

    def loss(a):
        return jnp.sum(selective_scan_assoc(
            *a[:6], delta_bias=a[6], delta_softplus=True) ** 2)
    want = jax.grad(loss)(tuple(jnp.asarray(x[k]) for k in NAMES))
    split = _jax_split(x, lambda a, mesh: jax.grad(
        lambda b: jnp.sum(jax_seq_parallel(
            *b[:6], delta_bias=b[6], delta_softplus=True, mesh=mesh,
            seq_axis="seq", impl="assoc") ** 2))(a))
    results = port[world]["grads"]
    for name, w, s in zip(NAMES, want, split):
        grads = [r["grads"][name] for r in results]
        if name in ("u", "delta", "B", "C"):
            got = torch.cat(grads, dim=-1)       # each rank's slice of L
        else:
            got = sum(grads)                     # each rank's contribution
        _close(got, w, 1e-4)
        _close(got, s, 1e-4)


def test_refuses_an_unknown_impl_and_a_missing_group():
    from medmamba_tpu_torch.ops.seq_parallel import \
        selective_scan_seq_parallel

    x = {k: torch.from_numpy(v) for k, v in _mk(3, l=8).items()}
    args = tuple(x[k] for k in NAMES[:6])
    with pytest.raises(ValueError, match="impl"):
        selective_scan_seq_parallel(*args, impl="pallas", group=object())
    with pytest.raises(ValueError, match="mesh or a group"):
        selective_scan_seq_parallel(*args)
