"""The scan kernels' bfloat16 compute mode (``MEDMAMBA_SCAN_COMPUTE=bfloat16``)
in the port, on the CPU.

The JAX side runs its scan kernels in Pallas interpret mode with the
variable set (``_ssd_core_compact``/``_ssd_forward_core``/``_part_bwd`` under
the default ``ssd``, ``_fwd_kernel``/``_bwd_kernel`` under ``hillis``), as
``tests/test_selective_scan.py`` runs the mode. The port's side runs the
plain versions of K1-K4 in the mode (``compute="bfloat16"``): the kernels
themselves run only on the card (``test_torch_port_cuda.py`` holds them to
these plain versions). The two round at different points (the TPU kernels
round their chunked matmul forms' factor cubes, the port its sequential
walk's per-step factors), so they are held to each other by the mode's own
accuracy: y, the states and the last state within 2e-2 of each output's
largest entry (JAX's bound for its mode against the float32 oracle,
``tests/test_selective_scan.py``), the seven gradients within 3e-2. On
these inputs y lands within 2.7e-3 to 6.3e-3, the last state within
1.2e-2 (hillis, L 200) and the gradients within 1.4e-3 to 1.7e-2 (dA,
ssd, L 128). The port's float32 plain versions sit within 1.8e-2 of JAX's
mode too, so the tests also show that the port's mode moved: its y, last
state and gradients differ from its float32 ones by 1.4e-3 to 6.4e-3 of
scale (at least 1e-3 is asked), and at L 1 each plain version equals a
numpy computation that rounds at the stated points, bit for bit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmamba_tpu.ops import pallas_scan as jps
from medmamba_tpu_torch.data.transforms import preprocess
from medmamba_tpu_torch.ops import scan_cuda, scan_hillis, scan_op
from medmamba_tpu_torch.ops import selective_scan as ts
from medmamba_tpu_torch.utils import export as texport
from test_torch_port_hillis import NAMES, _case, _jax, _torch
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

TOL_Y = 2e-2
TOL_GRAD = 3e-2
LIVE = 1e-3
# (L, input dtype, reverse flags): one short chunk, one whole chunk, a
# masked last chunk; both input dtypes; a reverse group (a
# forward-prefix/reverse-suffix call, the SS2D pattern)
PARITY_CASES = [(49, "float32", None), (128, "float32", None),
                (200, "float32", None), (200, "bfloat16", None),
                (200, "float32", (False, True)),
                (128, "bfloat16", (False, True))]


@pytest.fixture
def bf16_mode(monkeypatch):
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", "bfloat16")


def _rel(got, want) -> float:
    got = np.asarray(got.float()) if isinstance(got, torch.Tensor) \
        else np.asarray(jnp.asarray(got, jnp.float32))
    want = np.asarray(want.float()) if isinstance(want, torch.Tensor) \
        else np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _jax_mode(x, gy, rev):
    """JAX's y, last state and the seven gradients, in the mode the
    environment sets."""
    def loss(*args):
        y = jps.selective_scan_pallas(*args, delta_softplus=True,
                                      reverse_dirs=rev)
        return jnp.sum(y.astype(jnp.float32) * gy)
    y, last = jps.selective_scan_pallas(*_jax(x), delta_softplus=True,
                                        return_last_state=True,
                                        reverse_dirs=rev)
    return y, last, jax.grad(loss, argnums=tuple(range(7)))(*_jax(x))


def _jax_chunk_states(x):
    """JAX's state entering each 128-step chunk of a left-to-right scan,
    (b, d, n_chunks, N), from the kernel the environment selects."""
    b, d, l = x["delta"].shape
    n = x["A"].shape[1]
    u4, dt4, A3, B4, C4, D2, bias2, _, _ = jps._layout(
        *_jax(x), scan_hillis.CHUNK)
    _, st, _ = jps._fwd_pallas(u4, dt4, A3, B4, C4, D2, bias2,
                               scan_hillis.CHUNK, l)
    return np.asarray(st).transpose(0, 1, 3, 2, 4).reshape(b, d, -1, n)


def _port(kernel, x, gy, rev, compute):
    """The port's plain versions in the mode ``compute``: y, the last
    state, the 128-step chunk-entry states of a left-to-right call (None
    with reverse groups) and the seven gradients."""
    args = _torch(x)
    gy = torch.from_numpy(gy)
    if kernel == "hillis":
        xs = _torch(x, grad=True)
        y, last = ts._hillis_scan(
            *xs, True, True, rev, 1, None, ts.selective_scan_hillis_ref,
            ts.selective_scan_hillis_bwd_ref, compute)
        y.backward(gy)
        grads = [a.grad for a in xs]
        states = None if rev else ts.selective_scan_hillis_ref(
            *args, delta_softplus=True, compute=compute)[1]
        return y.detach(), last.detach(), states, grads
    u, delta, A, B, C, D, bias = args
    y, last = ts._plain_scan(*args, True, True, rev, 1, None, None, compute)
    tiles = ts.selective_scan_states_ref(u, delta, A, B, C, bias, True, rev,
                                         compute=compute)
    grads = ts.selective_scan_bwd_ref(*args, tiles, gy, delta_softplus=True,
                                      reverse_dirs=rev, compute=compute)
    return y, last, None if rev else tiles[:, :, ::2], grads


@pytest.mark.parametrize("l,dtype,rev", PARITY_CASES)
@pytest.mark.parametrize("kernel", ["ssd", "hillis"])
def test_plain_versions_match_jax_bf16_mode(bf16_mode, monkeypatch, kernel,
                                            l, dtype, rev):
    """K1 + K2 (ssd) or K3 + K4 (hillis, reverse groups flipped around the
    scan by ``_hillis_scan``) in the mode against the JAX kernels in the
    mode: y, the last state, the chunk-entry states of a left-to-right call
    and all seven gradients."""
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", kernel)
    x, gy = _case(l + 17, l, dtype)
    y_j, last_j, grads_j = _jax_mode(x, gy, rev)
    y, last, states, grads = _port(kernel, x, gy, rev, "bfloat16")
    assert y.dtype == torch.float32 and last.dtype == torch.float32
    assert _rel(y, y_j) <= TOL_Y
    assert _rel(last, last_j) <= TOL_Y
    if states is not None:
        assert _rel(states, _jax_chunk_states(x)) <= TOL_Y
    for name, a, g, w in zip(NAMES, _torch(x), grads, grads_j):
        assert g.dtype == a.dtype and g.shape == a.shape, name
        assert _rel(g, w) <= TOL_GRAD, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["ssd", "hillis"])
def test_the_mode_moves_the_plain_versions(kernel, dtype):
    """The mode is live: y and each gradient that the mode's roundings
    reach differ from the float32 plain versions' by at least 1e-3 of
    scale; dD (a sum of gy u, which no rounding reaches) keeps its bits."""
    x, gy = _case(41, 200, dtype)
    rev = (False, True)
    y16, last16, _, g16 = _port(kernel, x, gy, rev, "bfloat16")
    y32, last32, _, g32 = _port(kernel, x, gy, rev, "float32")
    assert _rel(y16, y32) >= LIVE and _rel(last16, last32) >= LIVE
    for name, a, b in zip(NAMES, g16, g32):
        if name == "D":
            assert torch.equal(a, b)
        else:
            assert _rel(a, b) >= LIVE, name


def _bf16_np(x):
    """x rounded to the nearest bfloat16 (ties to even), as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


def _l1_inputs():
    """One step (L 1) from a zero state, softplus off, no bias, 2 channels
    a group: B is zero but at state 0, so every sum over states holds one
    term and every other sum two, and any order of them gives the same
    bits; the values themselves are arbitrary float32s."""
    rng = np.random.default_rng(21)
    b, g, dpg, n = 2, 2, 2, 16
    d = g * dpg
    f32 = np.float32
    B = np.zeros((b, g, n, 1), f32)
    B[:, :, 0] = rng.standard_normal((b, g, 1))
    return dict(u=rng.standard_normal((b, d, 1)).astype(f32),
                delta=(0.5 + rng.random((b, d, 1))).astype(f32),
                A=(-np.exp(rng.standard_normal((d, n)))).astype(f32),
                B=B, C=rng.standard_normal((b, g, n, 1)).astype(f32),
                D=rng.standard_normal(d).astype(f32)), \
        rng.standard_normal((b, d, 1)).astype(f32)


def _l1_numpy(x, gy, hillis):
    """The mode's roundings at L 1 in numpy: y, last and the gradients
    (du, ddelta, dA, dB, dC, dD) of K1/K2 or, with ``hillis``, K3/K4."""
    r = _bf16_np
    g = x["B"].shape[1]
    per = x["delta"].shape[1] // g
    grp = lambda a: np.repeat(a, per, axis=1)      # (b, g, ..) -> (b, d, ..)
    dt, u = x["delta"][..., 0], x["u"][..., 0]
    Br, C = grp(r(x["B"][..., 0])), grp(x["C"][..., 0])
    gyv = gy[..., 0]
    h = r(r(dt * u)[..., None] * Br)                 # (b, d, N): a*0 + b
    hc = r(h * r(C)) if hillis else h * C
    y = hc.sum(-1) + u * x["D"]
    dh = r(r(C) * r(gyv)[..., None])                 # q, the carry is 0
    dhB = (dh * dt[..., None] * Br).sum(-1)
    du = (dt * (dh * Br).sum(-1) if hillis else dhB) + gyv * x["D"]
    ddt = u * (dh * Br).sum(-1) if hillis else \
        (dh * (u[..., None] * Br)).sum(-1)
    b, d = dt.shape
    pair = lambda a: a.reshape(b, g, per, -1).sum(2)  # two channels a group
    dB = pair(dh * (dt * u)[..., None])
    dC = pair(h * gyv[..., None])
    dD = (gyv * u).sum(0)
    return (y[..., None], h, du[..., None], ddt[..., None],
            np.zeros_like(x["A"]), dB[..., None], dC[..., None], dD)


@pytest.mark.parametrize("kernel", ["ssd", "hillis"])
def test_plain_versions_round_at_the_stated_points(kernel):
    """At L 1 from a zero state: y, the last state and every gradient of
    the plain versions in the mode equal a numpy computation that rounds
    dt u, B, the input b, C (K3's y and q), gy and q (and K3's h C) to
    bfloat16 where the module's docstring says, bit for bit."""
    x, gy = _l1_inputs()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"], None)
    gy_t = torch.from_numpy(gy)
    if kernel == "hillis":
        y, states, last = ts.selective_scan_hillis_ref(*args,
                                                       compute="bfloat16")
        grads = ts.selective_scan_hillis_bwd_ref(*args, states, gy_t,
                                                 compute="bfloat16")
    else:
        y, last = ts.selective_scan_ref(*args, return_last_state=True,
                                        compute="bfloat16")
        states = ts.selective_scan_states_ref(*args[:5], compute="bfloat16")
        grads = ts.selective_scan_bwd_ref(*args, states, gy_t,
                                          compute="bfloat16")
    assert not states.any() and grads[6] is None
    want = _l1_numpy(x, gy, kernel == "hillis")
    got = (y, last, *grads[:6])
    for name, g, w in zip(("y", "last", "du", "ddelta", "dA", "dB", "dC",
                           "dD"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the roundings are there: float32 gives other bits
    y32 = ts.selective_scan_ref(*args)
    assert not torch.equal(y32, y)


def test_compute_selector_is_read_at_each_call(monkeypatch):
    """Only ``bfloat16`` selects the mode, read at each call; a CPU
    tensor's scan is float32 whatever the variable says."""
    card = types.SimpleNamespace(is_cuda=True)
    cpu = torch.zeros(1)
    monkeypatch.delenv("MEDMAMBA_SCAN_COMPUTE", raising=False)
    assert ts._compute_mode(card) == ts._compute_mode(cpu) == "float32"
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", "bfloat16")
    assert ts._compute_mode(card) == "bfloat16"
    assert ts._compute_mode(cpu) == "float32"
    for other in ("float32", "bf16", "float16", ""):
        monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", other)
        assert ts._compute_mode(card) == "float32", other
    for bad in ("bf16", "float16"):
        with pytest.raises(ValueError, match="compute"):
            ts._rounding(bad)
        with pytest.raises(ValueError, match="compute"):
            scan_cuda.compute_code(bad)


def test_cpu_scans_ignore_the_variable(bf16_mode):
    """Under the variable a CPU tensor's scan, its last state and its
    gradients keep the float32 plain scan's bits, through the graph op
    (no gradient) and through autograd."""
    x, gy = _case(9, 150)
    kw = dict(delta_softplus=True, reverse_dirs=(False, True),
              return_last_state=True)
    y, last = ts.selective_scan(*_torch(x), **kw)
    y_r, last_r = ts._plain_scan(*_torch(x), True, True, (False, True), 1,
                                 None, None, "float32")
    assert torch.equal(y, y_r) and torch.equal(last, last_r)
    xs, xr = _torch(x, grad=True), _torch(x, grad=True)
    ts.selective_scan(*xs, **kw)[0].backward(torch.from_numpy(gy))
    ts.selective_scan(*xr, impl="ref", **kw)[0].backward(
        torch.from_numpy(gy))
    for name, a, b in zip(NAMES, xs, xr):
        assert torch.equal(a.grad, b.grad), name


def _recording(fn, seen):
    def run(*args, compute="float32", **kw):
        seen.append(compute)
        return fn(*args, compute=compute, **kw)
    return run


def test_kernel_scan_backward_runs_in_the_forwards_mode(monkeypatch):
    """``_KernelScan`` keeps the forward's mode for K2, whatever the
    variable says by the backward: K1 and K2 replaced by CPU stand-ins
    that record the mode they are given."""
    seen = []

    def k1(u, delta, A, B, C, D, bias, *, return_last_state, return_states,
           delta_softplus, reverse_dirs, u_tile, out_dtype, valid_len,
           compute):
        seen.append(compute)
        args = (u, delta, A, B, C, D, bias)
        y, last = ts._plain_scan(*args, delta_softplus, True, reverse_dirs,
                                 u_tile, out_dtype, valid_len, compute)
        states = ts.selective_scan_states_ref(
            u, delta, A, B, C, bias, delta_softplus, reverse_dirs, u_tile,
            valid_len, compute=compute)
        return y, last, states

    monkeypatch.setattr(scan_cuda, "selective_scan_fwd", k1)
    monkeypatch.setattr(scan_cuda, "selective_scan_bwd",
                        _recording(ts.selective_scan_bwd_ref, seen))
    x, gy = _case(13, 100)
    xs = _torch(x, grad=True)
    kw = dict(delta_softplus=True, reverse_dirs=(False, True), u_tile=1,
              out_dtype=None, valid_len=None, compute="bfloat16")
    y = ts._KernelScan.apply(*xs, False, kw)
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", "float32")
    y.backward(torch.from_numpy(gy))
    assert seen == ["bfloat16", "bfloat16"]
    args = _torch(x)
    tiles = ts.selective_scan_states_ref(*args[:5], args[6], True,
                                         (False, True), compute="bfloat16")
    want = ts.selective_scan_bwd_ref(*args, tiles, torch.from_numpy(gy),
                                     delta_softplus=True,
                                     reverse_dirs=(False, True),
                                     compute="bfloat16")
    for name, a, w in zip(NAMES, xs, want):
        assert torch.equal(a.grad, w), name


def test_hillis_scan_backward_runs_in_the_forwards_mode(monkeypatch):
    """``_HillisScan`` hands the forward's mode to its backward."""
    seen = []
    x, gy = _case(15, 100)
    xs = _torch(x, grad=True)
    y = ts._hillis_scan(*xs, True, False, (True, False), 1, None,
                        _recording(ts.selective_scan_hillis_ref, seen),
                        _recording(ts.selective_scan_hillis_bwd_ref, seen),
                        "bfloat16")
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", "float32")
    y.backward(torch.from_numpy(gy))
    assert seen == ["bfloat16", "bfloat16"]


@pytest.mark.parametrize("rev", [None, (True, False)])
def test_scan_op_carries_the_mode(rev):
    """``compute`` is an argument of the graph op: its CPU kernel runs the
    plain version in that mode (bits), its fake kernel passes opcheck."""
    x, _ = _case(19, 70)
    args = (*_torch(x), True, True, rev, 1, None, None)
    torch.library.opcheck(scan_op.selective_scan_fwd, (*args, "bfloat16"))
    got = scan_op.selective_scan_fwd(*args, "bfloat16")
    want = ts._plain_scan(*args, "bfloat16")
    f32 = scan_op.selective_scan_fwd(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _rel(got[0], f32[0]) >= LIVE


class _ScanHead(torch.nn.Module):
    """Float (b, 32, 32, 3) frames cut into one scan's operands (4 channels
    in 2 groups, N 4, L 64); logits from y's mean: a model whose output
    the scan decides."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(5)
        self.A = torch.nn.Parameter(-torch.rand(4, 4, generator=gen) - 0.5)
        self.D = torch.nn.Parameter(torch.randn(4, generator=gen))
        self.bias = torch.nn.Parameter(0.1 * torch.randn(4, generator=gen))

    def forward(self, x):
        v = x.reshape(x.shape[0], -1)[:, :1536]
        u, delta, B, C = torch.split(v, (256, 256, 512, 512), dim=1)
        b = x.shape[0]
        y = ts.selective_scan(
            u.reshape(b, 4, 64), delta.reshape(b, 4, 64), self.A,
            B.reshape(b, 2, 4, 64), C.reshape(b, 2, 4, 64), self.D,
            self.bias, delta_softplus=True, reverse_dirs=(False, True))
        return y.mean(-1)[:, :3]


def test_exported_artifact_keeps_its_mode(monkeypatch):
    """A model exported while the selector gives the bfloat16 mode (the
    CPU's float32 rule lifted for the test, as on the card): its scan node
    carries the mode, and the artifact, called with the selector back to
    float32, gives the live model's probabilities in the mode, 1e-3 of
    scale or more from float32's; an artifact exported in float32 stays
    float32 under the mode."""
    model = _ScanHead().eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    kw = dict(image_size=32, with_preprocess=False, device="cpu")

    def live():
        with torch.no_grad():
            return torch.softmax(model(x), -1)
    art32 = texport.load_exported(texport.export_forward(model, **kw))
    with monkeypatch.context() as m:
        m.setattr(ts, "_compute_mode", lambda _: "bfloat16")
        art16 = texport.load_exported(texport.export_forward(model, **kw))
        live16, f32_under_mode = live(), art32.call(x)
    assert art16.scan_compute() == ["bfloat16"]
    assert art32.scan_compute() == ["float32"]
    got = art16.call(x)
    assert torch.equal(got, live16)
    assert torch.equal(f32_under_mode, art32.call(x))
    assert _rel(got, live()) >= LIVE
