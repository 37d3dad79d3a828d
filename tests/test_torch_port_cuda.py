"""The CUDA kernels against their plain versions, on the card.

K1 (selective-scan forward, with its tile-entry states), K2 (its backward),
K3 and K4 (the scan of ``MEDMAMBA_SCAN_KERNEL=hillis`` and its backward,
held against the JAX package's doubling written in plain PyTorch), K5 (flip
+ rotation), the probes P1 and P2, the launch counts of a Grad-CAM, the
graph ops of ``ops/scan_op.py`` and an exported artifact on the card, and
the compiled steps (``-k graph``: CUDA graphs of the forward and the train
step against the eager ones, bit for bit where two eager runs agree), and
the other models (``-k "backbone or vssmseg"``: the CAM backbones' logits
against the CPU's, ``VSSMSeg``'s 40 K1 a forward and 40 K2 a backward),
and distribution (``-k "distributed or seq_parallel or last_state"``: the
kernel path refusing a gradient through the last state, a world-1 NCCL
group's graphed step against the eager step without a group, the
sequence-parallel scan over two gloo ranks on the card; on a machine with
several cards, one NCCL rank a card: the graphed steps against the eager
ones under the group, and ``cli.train`` against one process), and tensor
parallelism (``-k across_cards`` on four cards: the graphed TP step of
medmamba_t on a 2x2 and a 1x4 mesh against the eager one, its launches
and rows, and its first loss against one process), and tracing (``-k tracing``: the
step markers of a replayed train step and forward in order on the card,
K2 inside the backward phase, the host spans on the profiler's clock
before each replay's first marker, the graph counters and node gauge).
Marked ``cuda``: each test skips where
torch sees no GPU. On a machine with one: ``python -m pytest --noconftest
tests/test_torch_port_cuda.py -q``. Tolerances: float32 outputs 1e-4 (the two
differ only in the order of float32 operations and fused multiply-adds;
K2's gradients relative to each gradient's largest entry, since it sums
over channels, states and steps in another order); bfloat16 outputs 1e-2
(their last rounding, 2^-8 relative); K5 and P2 exact; P1 as
``probe_vpu.TOL``.
"""
import math

import numpy as np
import pytest
import torch

from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.ops import rotate, scan_cuda, scan_hillis, scan_op
from medmamba_tpu_torch.ops import selective_scan as ss
from medmamba_tpu_torch.ops.selective_scan import (
    selective_scan, selective_scan_bwd_ref, selective_scan_hillis_bwd_ref,
    selective_scan_hillis_ref, selective_scan_states_ref)
from medmamba_tpu_torch.tools import probe_mosaic, probe_vpu
from medmamba_tpu_torch.train.trainer import cross_entropy
from medmamba_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # the port's entry points fix float32 without TF32 here
    return resolve_device("cuda")


def _inputs(device, b=3, g=2, dpg=24, l=150, u_tile=1, dtype=torch.float32):
    gen = torch.Generator(device="cpu").manual_seed(0)
    d = g * dpg

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(device)

    return dict(
        u=rnd(b, d // u_tile, l).to(dtype),
        delta=rnd(b, d, l, scale=0.5).to(dtype),
        A=-torch.exp(rnd(d, 16, scale=0.5)), B=rnd(b, g, 16, l).to(dtype),
        C=rnd(b, g, 16, l).to(dtype), D=rnd(d), delta_bias=rnd(d, scale=0.1))


CASES = {
    "forward": dict(),
    "reverse": dict(reverse_dirs=(True, True)),
    "mixed": dict(reverse_dirs=(False, True), return_last_state=True),
    "valid_len": dict(reverse_dirs=(True, True), valid_len=131),
    "u_tile": dict(u_tile=2, reverse_dirs=(False, True)),
    "odd_channels": dict(dpg=13, return_last_state=True),
    "bf16_in": dict(dtype=torch.bfloat16),
    "bf16_out": dict(dtype=torch.bfloat16, out_dtype=torch.bfloat16,
                     reverse_dirs=(True, True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case):
    kw = dict(CASES[case])
    shape = {k: kw.pop(k) for k in ("dpg", "dtype") if k in kw}
    x = _inputs(cuda, u_tile=kw.get("u_tile", 1), **shape)
    got = selective_scan(**x, delta_softplus=True, **kw)
    want = selective_scan(**x, delta_softplus=True, impl="ref", **kw)
    torch.cuda.synchronize()
    tol = 1e-2 if kw.get("out_dtype") == torch.bfloat16 else 1e-4
    if kw.get("return_last_state"):
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        got, want = got[0], want[0]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# shapes at K1's edges, each at both of its widths: channel counts that its
# 32-channel blocks do not divide (4, 13, 40), lengths around its 64-step tile
# (1, 49, 63, 65, 100: float32 rows at 49, 63 and 65 and bfloat16 rows at
# 49, 63, 65 and 100 are not 16-byte aligned and take its plain-load
# staging), medmamba_t's first stage (3136 = 49 full tiles), the SS2D padding
# pattern (3200 with valid_len 3136), a shared u with mixed directions, and
# batch 1 (8-channel blocks only). "wide" raises the batch until there are
# 132 blocks of 32 channels, where K1 launches that layout; "narrow" keeps a
# batch below it, where K1 launches 8-channel blocks.
K1_EDGE_SHAPES = {
    "dpg4": dict(dpg=4),
    "dpg13": dict(dpg=13),
    "dpg40": dict(dpg=40),
    "l1": dict(l=1),
    "l49": dict(l=49),
    "l63": dict(l=63),
    "l65": dict(l=65),
    "l100": dict(l=100),
    "l3136": dict(l=3136, dpg=8, b=1),
    "valid_len": dict(l=3200, valid_len=3136, dpg=8, b=1),
    "u_tile": dict(u_tile=2),
    "batch1": dict(b=1),
}
K1_EDGE_CASES = [(shape, width) for shape in sorted(K1_EDGE_SHAPES)
                 for width in ("narrow", "wide")
                 if not (shape == "batch1" and width == "wide")]


def _k1_edge_launch(cuda, shape, width, reverse, dtype):
    """K1 at one edge shape and width; returns its outputs, the plain
    versions' and the operands' dtype."""
    kw = dict(K1_EDGE_SHAPES[shape])
    dims = {k: kw.pop(k) for k in ("b", "dpg", "l") if k in kw}
    u_tile = kw.pop("u_tile", 1)
    g, dpg = 2, dims.get("dpg", 24)
    if width == "wide":
        dims["b"] = -(-132 // (g * -(-dpg // 32)))
    b = dims.get("b", 3)
    dtype = getattr(torch, dtype)
    cfg = scan_cuda.selective_scan_fwd_config(b, g, dpg, dtype, dtype)
    assert cfg["channels_per_block"] == (32 if width == "wide" else 8), cfg
    kw["reverse_dirs"] = (not reverse, reverse) if u_tile > 1 \
        else (reverse, reverse)
    x = _inputs(cuda, u_tile=u_tile, dtype=dtype, **dims)
    got = scan_cuda.selective_scan_fwd(
        **x, delta_softplus=True, u_tile=u_tile, out_dtype=dtype,
        return_last_state=True, return_states=True, **kw)
    want = selective_scan(**x, delta_softplus=True, impl="ref", u_tile=u_tile,
                          out_dtype=dtype, return_last_state=True, **kw)
    want_states = selective_scan_states_ref(
        x["u"], x["delta"], x["A"], x["B"], x["C"], x["delta_bias"], True,
        kw["reverse_dirs"], u_tile, kw.get("valid_len"))
    torch.cuda.synchronize()
    return got, (*want, want_states), dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,width", K1_EDGE_CASES)
def test_forward_matches_plain_version_at_edge_shapes(cuda, shape, width,
                                                      reverse, dtype):
    """y (float32 1e-4, bfloat16 y 1e-2), the last state and the
    tile-entry states (float32, 1e-4) against the plain versions."""
    (y, last, states), (y_r, last_r, states_r), dt = _k1_edge_launch(
        cuda, shape, width, reverse, dtype)
    assert y.dtype == y_r.dtype == dt
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y, y_r, rtol=tol, atol=tol)
    torch.testing.assert_close(last, last_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(states, states_r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_forward_is_deterministic(cuda, width):
    """Two launches on the same inputs give the same bits: y, the last
    state and the tile-entry states (K1 writes no output with an atomic)."""
    x = _inputs(cuda, b=3 if width == "narrow" else 66, dpg=40, l=200)
    kw = dict(delta_softplus=True, reverse_dirs=(False, True),
              return_last_state=True, return_states=True)
    first = scan_cuda.selective_scan_fwd(**x, **kw)
    second = scan_cuda.selective_scan_fwd(**x, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_model_runs_the_kernel_twice_per_block(cuda):
    assert not torch.backends.cudnn.allow_tf32
    model = tv.VSSM(num_classes=3, depths=(1, 2), dims=(16, 32)).to(cuda).eval()
    ref = tv.VSSM(num_classes=3, depths=(1, 2), dims=(16, 32),
                  scan_impl="ref").to(cuda).eval()
    ref.load_state_dict(model.state_dict())
    x = torch.randn(2, 40, 40, 3, device=cuda)
    scan_cuda.LAUNCHES = 0
    with torch.no_grad():
        got = model(x)
        assert scan_cuda.LAUNCHES == 2 * 3
        want = ref(x)
    assert scan_cuda.LAUNCHES == 2 * 3
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")
BWD_CASES = {
    "forward": dict(),
    "reverse": dict(reverse_dirs=(True, True)),
    "mixed": dict(reverse_dirs=(False, True)),
    "valid_len": dict(reverse_dirs=(True, True), valid_len=131),
    "u_tile": dict(u_tile=2, reverse_dirs=(False, True)),
    "odd_channels": dict(dpg=13),
    "bf16": dict(dtype=torch.bfloat16, out_dtype=torch.bfloat16,
                 reverse_dirs=(True, True)),
    # the two mixed instantiations: float32 in with a bfloat16 gy, and
    # bfloat16 in with a float32 gy
    "fp32_in_bf16_gy": dict(out_dtype=torch.bfloat16),
    "bf16_in_fp32_gy": dict(dtype=torch.bfloat16, reverse_dirs=(False, True)),
    "no_skip_no_bias": dict(skip=False),
}


def _rel_close(got, want, tol):
    scale = want.float().abs().max().clamp_min(1e-30)
    err = ((got.float() - want.float()).abs().max() / scale).item()
    assert err <= tol, err


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_states_and_backward_match_plain_versions(cuda, case):
    _check_backward(cuda, BWD_CASES[case])


# shapes at K2's edges: channel counts that its 32-channel blocks do not
# divide, lengths that neither its 8-step sub-tiles nor the 64-step tiles
# divide (49, 100: a partial last sub-tile, walked as identity steps),
# medmamba_t's first stage (3136 = 49 full tiles), valid_len below L, a
# shared u. At these batches K1 makes the states with its 8-channel blocks;
# K1_EDGE_SHAPES above holds its states at both widths.
EDGE_SHAPES = {
    "dpg4": dict(dpg=4),
    "dpg40": dict(dpg=40),
    "l49": dict(l=49),
    "l100": dict(l=100),
    "l3136": dict(l=3136, b=1, dpg=8),
    "valid_len": dict(valid_len=131),
    "u_tile": dict(u_tile=2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", sorted(EDGE_SHAPES))
def test_backward_matches_plain_version_at_edge_shapes(cuda, shape, reverse,
                                                       dtype):
    kw = dict(EDGE_SHAPES[shape])
    if reverse:
        kw["reverse_dirs"] = (True, True)
    if dtype == "bfloat16":
        kw.update(dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    _check_backward(cuda, kw)


def test_backward_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits: K2 adds its
    partial sums in a fixed order and writes no output with an atomic."""
    x = _inputs(cuda, dpg=40, l=200)
    _, _, states = scan_cuda.selective_scan_fwd(
        **x, delta_softplus=True, reverse_dirs=(False, True),
        return_states=True)
    gy = torch.randn(x["delta"].shape, device=cuda)
    args = [x[k] for k in NAMES]
    kw = dict(delta_softplus=True, reverse_dirs=(False, True))
    first = scan_cuda.selective_scan_bwd(*args, states, gy, **kw)
    second = scan_cuda.selective_scan_bwd(*args, states, gy, **kw)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


def _check_backward(cuda, case):
    """K1's tile-entry states and K2 against their plain versions, each
    gradient relative to its largest entry."""
    kw = dict(case)
    shape = {k: kw.pop(k) for k in ("b", "dpg", "l", "dtype") if k in kw}
    skip = kw.pop("skip", True)
    x = _inputs(cuda, u_tile=kw.get("u_tile", 1), **shape)
    if not skip:
        x["D"] = x["delta_bias"] = None
    out_dtype = kw.pop("out_dtype", None)
    y, _, states = scan_cuda.selective_scan_fwd(
        **x, delta_softplus=True, out_dtype=out_dtype, return_states=True,
        **kw)
    want_states = selective_scan_states_ref(
        x["u"], x["delta"], x["A"], x["B"], x["C"], x["delta_bias"], True,
        kw.get("reverse_dirs"), kw.get("u_tile", 1), kw.get("valid_len"))
    torch.testing.assert_close(states, want_states, rtol=1e-4, atol=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(1)
    gy = torch.randn(y.shape, generator=gen, device=cuda).to(y.dtype)
    args = [x[k] for k in NAMES]
    got = scan_cuda.selective_scan_bwd(*args, states, gy, delta_softplus=True,
                                       **kw)
    want = selective_scan_bwd_ref(*args, want_states, gy,
                                  delta_softplus=True, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        _rel_close(g, w, tol)


def test_autograd_runs_k1_then_k2(cuda):
    x = _inputs(cuda)
    xk = {k: v.clone().requires_grad_(True) for k, v in x.items()}
    xr = {k: v.clone().requires_grad_(True) for k, v in x.items()}
    kw = dict(delta_softplus=True, reverse_dirs=(True, True))
    scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = 0
    y = selective_scan(**xk, **kw)
    y.backward(torch.ones_like(y))
    assert (scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES) == (1, 1)
    yr = selective_scan(**xr, impl="ref", **kw)
    yr.backward(torch.ones_like(yr))
    for k in NAMES:
        _rel_close(xk[k].grad, xr[k].grad, 1e-4)


def test_forward_wrapper_refuses_to_drop_a_gradient(cuda):
    x = _inputs(cuda)
    x["u"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward"):
        scan_cuda.selective_scan_fwd(**x, delta_softplus=True)


@pytest.mark.parametrize("size", [28, 224])
def test_rotation_kernel_matches_plain_version_exactly(cuda, size):
    gen = torch.Generator(device=cuda).manual_seed(size)
    x = torch.randn(6, size, size, 3, generator=gen, device=cuda)
    angles = (2 * torch.rand(6, generator=gen, device=cuda) - 1) \
        * math.radians(10)
    flip = torch.rand(6, generator=gen, device=cuda) < 0.5
    rotate.LAUNCHES = 0
    got = rotate.rotate_flip(x, angles, flip)
    assert rotate.LAUNCHES == 1
    want = rotate.rotate_flip_ref(x, torch.sin(angles), torch.cos(angles),
                                  flip)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_train_step_through_the_kernels_matches_the_plain_scan(cuda):
    """Float32 (TF32 off): the gradients of one training forward and
    backward through K1 + K2 against autograd through the plain loop,
    relative to each parameter's largest gradient (see below for the
    gradients that are zero in exact arithmetic); two K1 and two K2
    launches per block."""
    kw = dict(num_classes=3, depths=(1, 2), dims=(16, 32),
              drop_path_rate=0.0)
    model = tv.VSSM(**kw).to(cuda).train()
    ref = tv.VSSM(**kw, scan_impl="ref").to(cuda).train()
    ref.load_state_dict(model.state_dict())
    x = torch.randn(4, 40, 40, 3, device=cuda)
    labels = torch.tensor([0, 2, 1, -1], device=cuda)
    scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = 0
    cross_entropy(model(x, labels >= 0), labels).backward()
    assert (scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES) == (6, 6)
    cross_entropy(ref(x, labels >= 0), labels).backward()
    assert (scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES) == (6, 6)
    want = {n: p.grad for n, p in ref.named_parameters()}
    top = max(g.abs().max().item() for g in want.values())
    for name, p in model.named_parameters():
        if want[name].abs().max() >= 1e-3 * top:
            _rel_close(p.grad, want[name], 1e-4)
        else:
            # zero in exact arithmetic (a bias in front of a BatchNorm):
            # both sides hold rounding noise, bounded against the model's
            # largest gradient
            assert (p.grad - want[name]).abs().max() <= 1e-4 * top, name


# K3 and K4, the scan of MEDMAMBA_SCAN_KERNEL=hillis: L 150 ends in a
# short chunk, L 49 is a single short chunk, L 256 with valid_len 200 masks
# the last chunk
HILLIS_CASES = {
    "fp32": dict(),
    "bf16": dict(dtype=torch.bfloat16),
    "single_short_chunk": dict(l=49),
    "bf16_valid_len": dict(dtype=torch.bfloat16, l=256, valid_len=200),
    "odd_channels_no_skip": dict(dpg=13, skip=False),
}


@pytest.mark.parametrize("case", sorted(HILLIS_CASES))
def test_hillis_kernels_match_plain_versions(cuda, case):
    kw = dict(HILLIS_CASES[case])
    skip = kw.pop("skip", True)
    valid_len = kw.pop("valid_len", None)
    x = _inputs(cuda, **kw)
    if not skip:
        x["D"] = x["delta_bias"] = None
    args = [x[k] for k in NAMES]
    got = scan_hillis.selective_scan_hillis_fwd(
        *args, delta_softplus=True, valid_len=valid_len)
    want = selective_scan_hillis_ref(*args, delta_softplus=True,
                                     valid_len=valid_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(2)
    gy = torch.randn(got[0].shape, generator=gen, device=cuda)
    grads = scan_hillis.selective_scan_hillis_bwd(
        *args, want[1], gy, delta_softplus=True, valid_len=valid_len)
    want = selective_scan_hillis_bwd_ref(*args, want[1], gy,
                                         delta_softplus=True,
                                         valid_len=valid_len)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, grads, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _rel_close(g, w, 1e-2 if g.dtype == torch.bfloat16 else 1e-4)


# K3's edges: lengths around its walk's 64-step tiles and its 128-step chunks
# (1, 49 and 64 one tile, 127 and 128 one chunk of two tiles, 129 a third tile
# in a second chunk, 150 a short third tile; float32 rows at 1, 49, 127, 129
# and 150 and bfloat16 rows at 1, 49, 127, 129, 150 and 196 are not 16-byte
# aligned and take the 4-byte copies), valid_len below L in the first and in
# the last chunk, channel counts its blocks do not divide, and D and
# delta_bias None; each at both widths ("wide" raises the batch until there
# are 132 blocks of 32 channels, where K3 launches that layout)
HILLIS_FWD_EDGES = {
    "l1": dict(l=1), "l49": dict(l=49), "l64": dict(l=64),
    "l127": dict(l=127), "l128": dict(l=128), "l129": dict(l=129),
    "l150": dict(l=150), "dpg1": dict(dpg=1, l=129),
    "dpg5": dict(dpg=5, l=150), "dpg96": dict(dpg=96, l=196),
    "valid_len_first_chunk": dict(l=196, valid_len=100),
    "valid_len_last_chunk": dict(l=196, valid_len=150),
    "no_skip_no_bias": dict(l=129, skip=False),
}


def _hillis_fwd_launch(cuda, case, dtype, width):
    kw = dict(case)
    skip = kw.pop("skip", True)
    valid_len = kw.pop("valid_len", None)
    dpg = kw.get("dpg", 24)
    if width == "wide":
        kw["b"] = -(-132 // (2 * -(-dpg // 32)))
    x = _inputs(cuda, dtype=getattr(torch, dtype), **kw)
    if not skip:
        x["D"] = x["delta_bias"] = None
    args = [x[k] for k in NAMES]
    scan_hillis.HILLIS_LAUNCHES = 0
    got = scan_hillis.selective_scan_hillis_fwd(
        *args, delta_softplus=True, valid_len=valid_len)
    assert scan_hillis.HILLIS_LAUNCHES == 1
    want = selective_scan_hillis_ref(*args, delta_softplus=True,
                                     valid_len=valid_len)
    torch.cuda.synchronize()
    return args, valid_len, got, want


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(HILLIS_FWD_EDGES))
def test_hillis_forward_matches_plain_version_at_edge_shapes(cuda, shape,
                                                             dtype, width):
    """y, the chunk-entry states and the last state, all float32, against
    the doubling plain version: 1e-4 (both compute in float32 from the same
    inputs; the doubling and the sequential walk round differently)."""
    _, _, got, want = _hillis_fwd_launch(cuda, HILLIS_FWD_EDGES[shape],
                                         dtype, width)
    for part, g, w in zip(("y", "states", "last"), got, want):
        assert g.dtype == w.dtype == torch.float32, part
        assert g.shape == w.shape, part
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("l", [1, 49, 150, 3136])
def test_hillis_forward_at_batch_1(cuda, l):
    """Batch 1, a hillis CAM's shape, where K3 launches 8-channel blocks;
    medmamba_t's first stage at L 3136."""
    case = dict(b=1, l=l, dpg=96 if l == 3136 else 24)
    _, _, got, want = _hillis_fwd_launch(cuda, case, "float32", "narrow")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_hillis_forward_is_deterministic(cuda, width):
    """Two launches on the same inputs give the same bits: y, the chunk
    states and the last state (K3 writes no output with an atomic)."""
    case = dict(dpg=40, l=200, valid_len=180)
    args, valid_len, first, _ = _hillis_fwd_launch(cuda, case, "float32",
                                                   width)
    second = scan_hillis.selective_scan_hillis_fwd(
        *args, delta_softplus=True, valid_len=valid_len)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K4's edges: lengths around its 64-step tiles and K3's 128-step chunks (1,
# 49 and 64 one tile, 127 and 128 one chunk of two tiles, 129 a third tile in
# a second chunk, 150 and 196 a short last tile), valid_len below L in the
# first and in the last chunk, channel counts its 32-channel blocks do not
# divide, and D and delta_bias None
HILLIS_BWD_EDGES = {
    "l1": dict(l=1), "l49": dict(l=49), "l64": dict(l=64),
    "l127": dict(l=127), "l128": dict(l=128), "l129": dict(l=129),
    "l150": dict(l=150), "l196": dict(l=196),
    "valid_len_first_chunk": dict(l=196, valid_len=100),
    "valid_len_last_chunk": dict(l=196, valid_len=150),
    "dpg40": dict(dpg=40, l=150), "dpg13_l49": dict(dpg=13, l=49),
    "no_skip_no_bias": dict(l=129, skip=False),
}


def _hillis_bwd_operands(cuda, case):
    kw = dict(case)
    skip = kw.pop("skip", True)
    valid_len = kw.pop("valid_len", None)
    x = _inputs(cuda, b=2, **kw)
    if not skip:
        x["D"] = x["delta_bias"] = None
    args = [x[k] for k in NAMES]
    y, states, _ = scan_hillis.selective_scan_hillis_fwd(
        *args, delta_softplus=True, valid_len=valid_len)
    gen = torch.Generator(device=cuda).manual_seed(4)
    gy = torch.randn(y.shape, generator=gen, device=cuda)
    return args, states, gy, dict(delta_softplus=True, valid_len=valid_len)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(HILLIS_BWD_EDGES))
def test_hillis_backward_matches_plain_version_at_edge_shapes(cuda, shape,
                                                              dtype):
    """K4 from K3's chunk states against its plain version, each gradient
    relative to its largest entry."""
    case = dict(HILLIS_BWD_EDGES[shape], dtype=getattr(torch, dtype))
    args, states, gy, kw = _hillis_bwd_operands(cuda, case)
    scan_hillis.HILLIS_BWD_LAUNCHES = 0
    got = scan_hillis.selective_scan_hillis_bwd(*args, states, gy, **kw)
    assert scan_hillis.HILLIS_BWD_LAUNCHES == 1
    want = selective_scan_hillis_bwd_ref(*args, states, gy, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _rel_close(g, w, 1e-2 if g.dtype == torch.bfloat16 else 1e-4)


def test_hillis_backward_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits: K4 adds its
    partial sums in a fixed order and writes no output with an atomic."""
    args, states, gy, kw = _hillis_bwd_operands(
        cuda, dict(dpg=40, l=200, valid_len=180))
    first = scan_hillis.selective_scan_hillis_bwd(*args, states, gy, **kw)
    second = scan_hillis.selective_scan_hillis_bwd(*args, states, gy, **kw)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


def test_hillis_selector_runs_k3_then_k4(cuda, monkeypatch):
    """Under MEDMAMBA_SCAN_KERNEL=hillis the dispatcher reaches K3 and K4
    and never K1/K2; y is float32 whatever out_dtype asks; the gradients
    match the plain scan's."""
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", "hillis")
    x = _inputs(cuda)
    xk = {k: v.clone().requires_grad_(True) for k, v in x.items()}
    xr = {k: v.clone().requires_grad_(True) for k, v in x.items()}
    kw = dict(delta_softplus=True, reverse_dirs=(False, True))
    scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = 0
    scan_hillis.HILLIS_LAUNCHES = scan_hillis.HILLIS_BWD_LAUNCHES = 0
    y = selective_scan(**xk, out_dtype=torch.bfloat16, **kw)
    assert y.dtype == torch.float32
    y.backward(torch.ones_like(y))
    assert (scan_hillis.HILLIS_LAUNCHES, scan_hillis.HILLIS_BWD_LAUNCHES,
            scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES) == (1, 1, 0, 0)
    yr = selective_scan(**xr, impl="ref", **kw)
    yr.backward(torch.ones_like(yr))
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    for k in NAMES:
        _rel_close(xk[k].grad, xr[k].grad, 1e-4)


def test_hillis_launchers_raise_on_bad_operands(cuda):
    x = _inputs(cuda)
    args = [x[k] for k in NAMES]
    y, states, _ = scan_hillis.selective_scan_hillis_fwd(
        *args, delta_softplus=True)
    with pytest.raises(ValueError, match="gy"):
        scan_hillis.selective_scan_hillis_bwd(
            *args, states, y.to(torch.bfloat16), delta_softplus=True)
    with pytest.raises(ValueError, match="states"):
        scan_hillis.selective_scan_hillis_bwd(
            *args, states[:, :, :1].contiguous(), y, delta_softplus=True)
    with pytest.raises(ValueError, match="states"):
        scan_hillis.selective_scan_hillis_bwd(
            *args, states.double(), y, delta_softplus=True)
    with pytest.raises(ValueError, match="gy"):
        scan_hillis.selective_scan_hillis_bwd(
            *args, states, y.cpu(), delta_softplus=True)
    with pytest.raises(ValueError, match="B"):
        scan_hillis.selective_scan_hillis_bwd(
            *(dict(x, B=x["B"].to(torch.bfloat16))[k] for k in NAMES),
            states, y, delta_softplus=True)
    bad = dict(x, A=x["A"][:, :8].contiguous())
    with pytest.raises(ValueError, match="A"):
        scan_hillis.selective_scan_hillis_fwd(
            *(bad[k] for k in NAMES), delta_softplus=True)
    with pytest.raises(ValueError, match="valid_len"):
        scan_hillis.selective_scan_hillis_fwd(*args, valid_len=151)


@pytest.mark.parametrize("mode", probe_vpu.MODES)
def test_probe_vpu_kernel_matches_plain_version(cuda, mode):
    """P1 at (256, 512): float32 within 1e-4 of the largest entry and
    carrying the chain's effect within probe_vpu.WORK_TOL, bfloat16 within
    2e-2 (probe_vpu.TOL); ``iters`` chains the calls."""
    x = torch.randn(256, 512, generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    for dtype in probe_vpu.dtypes(mode):
        for k in probe_vpu.ks(mode):
            xd = x.to(dtype)
            probe_vpu.LAUNCHES = 0
            got = probe_vpu.probe_vpu(xd, k, mode)
            assert probe_vpu.LAUNCHES == 1 and got.dtype == dtype
            assert probe_vpu.rel_err(got, probe_vpu.probe_vpu_ref(
                xd, k, mode)) <= probe_vpu.TOL[dtype]
            twice = probe_vpu.probe_vpu_cuda(xd, k, mode, iters=2)
            assert probe_vpu.LAUNCHES == 3
            assert probe_vpu.rel_err(twice, probe_vpu.probe_vpu_ref(
                got, k, mode)) <= probe_vpu.TOL[dtype]
            if dtype == torch.float32:
                # exp's first call ends at its chain's fixed point, where
                # the second call has no effect to carry
                pairs = [(got, xd)] + ([] if mode == "exp" else [(twice, got)])
                for out, inp in pairs:
                    share = probe_vpu.work_share(out, inp, k, mode)
                    assert abs(share - 1) <= probe_vpu.WORK_TOL, (k, share)


def test_probe_mosaic_kernels_equal_plain_versions(cuda):
    xs = probe_mosaic.inputs(cuda)
    probe_mosaic.LAUNCHES = 0
    for i, p in enumerate(probe_mosaic.PROBES):
        got = probe_mosaic.probe_mosaic(i, xs[p.operand])
        torch.testing.assert_close(got, p.plain(xs[p.operand]), rtol=0,
                                   atol=0)
    assert probe_mosaic.LAUNCHES == len(probe_mosaic.PROBES)


def test_probe_mosaic_launcher_raises_on_bad_operands(cuda):
    """The launcher refuses a wrong shape, dtype or device, a strided
    operand, or a contiguous one off the 16-byte alignment the kernels'
    float4 reads need, and launches nothing then."""
    xs = probe_mosaic.inputs(cuda)
    x4 = xs["x4"]
    shifted = torch.empty(x4.numel() + 1, device=cuda)[1:].view(x4.shape)
    shifted.copy_(x4)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    probe_mosaic.LAUNCHES = 0
    for bad in (xs["xw"], x4.double(), x4.cpu(),
                x4.transpose(0, 1).contiguous().transpose(0, 1), shifted):
        with pytest.raises(ValueError, match="probe 0 takes"):
            probe_mosaic.probe_mosaic_cuda(0, bad)
    with pytest.raises(ValueError, match="probe 1 takes"):
        probe_mosaic.probe_mosaic_cuda(1, x4)
    assert probe_mosaic.LAUNCHES == 0
    probe_mosaic.empty_launch(x4)
    torch.cuda.synchronize()
    assert probe_mosaic.LAUNCHES == 0


@pytest.mark.parametrize("scan", ["ssd", "hillis"])
def test_grad_cam_launches_the_backward_only_downstream(cuda, scan,
                                                        monkeypatch):
    """Two stages (1 and 2 blocks, two scans a block): a CAM forward makes
    6 forward launches; its backward reaches the scans of the blocks after
    the target only. CAMs within 1e-4 of the plain scan's at the same
    activations (the kernels' forward's at the target and at every block's
    output, substituted into the plain one, so every ReLU masks the same
    elements)."""
    from medmamba_tpu_torch.eval.gradcam import (block_paths,
                                                 default_target_path,
                                                 grad_cam,
                                                 target_activations)

    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", scan)
    kw = dict(num_classes=3, depths=(1, 2), dims=(16, 32))
    model = tv.VSSM(**kw).to(cuda).eval()
    ref = tv.VSSM(**kw, scan_impl="ref").to(cuda).eval()
    ref.load_state_dict(model.state_dict())
    x = torch.randn(2, 32, 32, 3, device=cuda)
    tc = [0, 2]
    for target, downstream in ((None, 0), ("layers_1.blocks_0.conv1x1", 2),
                               ("layers_0.blocks_0.conv_bn0", 4)):
        scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = 0
        scan_hillis.HILLIS_LAUNCHES = scan_hillis.HILLIS_BWD_LAUNCHES = 0
        got = grad_cam(model, x, target_class=tc, target_path=target)
        counts = (scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES,
                  scan_hillis.HILLIS_LAUNCHES,
                  scan_hillis.HILLIS_BWD_LAUNCHES)
        want_counts = (6, downstream, 0, 0) if scan == "ssd" \
            else (0, 0, 6, downstream)
        assert counts == want_counts, (target, counts)
        sites = [target or default_target_path(model), *block_paths(model)]
        want = grad_cam(ref, x, target_class=tc, target_paths=sites[:1],
                        substitute=dict(zip(sites, target_activations(
                            model, x, sites))))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# medmamba_t's scan shapes at 224^2: channels per group and length
STAGE_SHAPES = [(96, 3136), (192, 784), (384, 196), (768, 49)]


def _op_args(x, **kw):
    """The graph ops' positional arguments: ``ops.selective_scan``'s
    call-site contract with delta_softplus."""
    kw = dict(dict(return_last_state=False, reverse_dirs=None, u_tile=1,
                   out_dtype=None, valid_len=None), **kw)
    return (*(x[k] for k in NAMES), True, kw["return_last_state"],
            kw["reverse_dirs"], kw["u_tile"], kw["out_dtype"],
            kw["valid_len"])


@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("stage", range(len(STAGE_SHAPES)))
def test_scan_op_gives_the_k1_wrappers_bits(cuda, stage, batch):
    """``medmamba::selective_scan_fwd`` on CUDA tensors is one K1 launch:
    y and the last state equal the direct wrapper's bits, a forward and a
    reverse group in one call, at the stage shapes of the eval forward and
    of a demo request."""
    dpg, l = STAGE_SHAPES[stage]
    x = _inputs(cuda, b=batch, dpg=dpg, l=l)
    want = scan_cuda.selective_scan_fwd(
        **x, delta_softplus=True, reverse_dirs=[False, True],
        return_last_state=True)
    scan_cuda.LAUNCHES = 0
    got = scan_op.selective_scan_fwd(*_op_args(
        x, reverse_dirs=[False, True], return_last_state=True))
    torch.cuda.synchronize()
    assert scan_cuda.LAUNCHES == 1 and len(got) == 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("op", ["selective_scan_fwd",
                                "selective_scan_hillis_fwd"])
def test_scan_ops_pass_opcheck_on_the_card(cuda, op):
    x = _inputs(cuda, b=2, dpg=8, l=70)
    torch.library.opcheck(getattr(scan_op, op), _op_args(
        x, reverse_dirs=[True, False], return_last_state=True,
        valid_len=60))


@pytest.mark.parametrize("scan", ["ssd", "hillis"])
def test_exported_model_launches_the_kernel_it_was_exported_with(
        cuda, scan, monkeypatch):
    """A tiny VSSM (3 blocks) exported on the card: each call of the
    artifact makes 2 launches a block of K1, or of K3 when exported under
    hillis, whichever kernel the environment names when it runs, and gives
    the live forward's probabilities."""
    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.utils.export import export_forward, load_exported

    kw = dict(num_classes=3, depths=(1, 2), dims=(16, 32))
    model = tv.VSSM(**kw).eval()
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", scan)
    blob = export_forward(model, image_size=32, device="cuda")
    model = model.to(cuda)
    x = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.no_grad():
        want = torch.softmax(model(preprocess(x, size=32)), -1)
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL",
                       "hillis" if scan == "ssd" else "ssd")
    exp = load_exported(blob)
    for b in (3, 1):
        scan_cuda.LAUNCHES = scan_hillis.HILLIS_LAUNCHES = 0
        got = exp.call(x[:b])
        torch.cuda.synchronize()
        counts = (scan_cuda.LAUNCHES, scan_hillis.HILLIS_LAUNCHES)
        assert counts == ((6, 0) if scan == "ssd" else (0, 6)), counts
        torch.testing.assert_close(got, want[:b], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op,module", [
    ("selective_scan_fwd", scan_cuda), ("selective_scan_hillis_fwd",
                                        scan_hillis)])
def test_scan_op_raises_a_failed_build_or_launch(cuda, op, module,
                                                 monkeypatch):
    """Nothing falls back: a kernel that does not build or does not launch
    raises through the op, and counts no launch."""
    from types import SimpleNamespace

    from medmamba_tpu_torch.ops import cuda_build

    args = _op_args(_inputs(cuda))
    fn = getattr(scan_op, op)
    failing = SimpleNamespace(
        medmamba_cuda_error_string=lambda rc: b"injected failure")
    setattr(failing, f"medmamba_{op}", lambda *a: 2)
    monkeypatch.setitem(cuda_build._libs, module.FWD_SOURCE, failing)
    scan_cuda.LAUNCHES = scan_hillis.HILLIS_LAUNCHES = 0
    with pytest.raises(RuntimeError, match="injected failure"):
        fn(*args)
    monkeypatch.delitem(cuda_build._libs, module.FWD_SOURCE)

    def no_compiler(*sources):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(cuda_build, "build", no_compiler)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn(*args)
    assert scan_cuda.LAUNCHES == scan_hillis.HILLIS_LAUNCHES == 0


# The bfloat16 compute mode (MEDMAMBA_SCAN_COMPUTE=bfloat16): each kernel in
# the mode against its plain version in the mode, at the edge shapes above,
# both widths, and the four stage shapes at batch 1. The roundings fall on
# the same float32 values in both (exp, softplus and the products they
# round come from the same float32 operations, and a product of two
# bfloat16 values is exact), so the float32 tolerances hold: the walks
# differ only in the order of their float32 sums.
BF16 = "bfloat16"


def _bf16_forward(cuda, x, kw, out_dtype=None):
    """K1 in the mode and its plain versions: (y, last, states) each."""
    got = scan_cuda.selective_scan_fwd(
        **x, delta_softplus=True, out_dtype=out_dtype,
        return_last_state=True, return_states=True, compute=BF16, **kw)
    args = [x[k] for k in NAMES]
    y, last = ss._plain_scan(*args, True, True, kw.get("reverse_dirs"),
                             kw.get("u_tile", 1), out_dtype,
                             kw.get("valid_len"), BF16)
    states = selective_scan_states_ref(
        x["u"], x["delta"], x["A"], x["B"], x["C"], x["delta_bias"], True,
        kw.get("reverse_dirs"), kw.get("u_tile", 1), kw.get("valid_len"),
        compute=BF16)
    torch.cuda.synchronize()
    return got, (y, last, states)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,width", K1_EDGE_CASES)
def test_bf16_mode_forward_matches_plain_version_at_edge_shapes(
        cuda, shape, width, reverse, dtype):
    kw = dict(K1_EDGE_SHAPES[shape])
    dims = {k: kw.pop(k) for k in ("b", "dpg", "l") if k in kw}
    u_tile = kw.pop("u_tile", 1)
    g, dpg = 2, dims.get("dpg", 24)
    if width == "wide":
        dims["b"] = -(-132 // (g * -(-dpg // 32)))
    dt = getattr(torch, dtype)
    cfg = scan_cuda.selective_scan_fwd_config(dims.get("b", 3), g, dpg, dt,
                                              dt, BF16)
    assert cfg["channels_per_block"] == (32 if width == "wide" else 8), cfg
    kw["reverse_dirs"] = (not reverse, reverse) if u_tile > 1 \
        else (reverse, reverse)
    kw["u_tile"] = u_tile
    x = _inputs(cuda, u_tile=u_tile, dtype=dt, **dims)
    (y, last, states), (y_r, last_r, states_r) = _bf16_forward(cuda, x, kw,
                                                               dt)
    assert y.dtype == y_r.dtype == dt
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y, y_r, rtol=tol, atol=tol)
    torch.testing.assert_close(last, last_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(states, states_r, rtol=1e-4, atol=1e-4)


def _bf16_backward(cuda, case):
    """K1's states and K2 in the mode against their plain versions."""
    kw = dict(case)
    shape = {k: kw.pop(k) for k in ("b", "dpg", "l", "dtype") if k in kw}
    x = _inputs(cuda, u_tile=kw.get("u_tile", 1), **shape)
    out_dtype = kw.pop("out_dtype", None)
    (y, _, states), (_, _, want_states) = _bf16_forward(cuda, x, kw,
                                                        out_dtype)
    torch.testing.assert_close(states, want_states, rtol=1e-4, atol=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(1)
    gy = torch.randn(y.shape, generator=gen, device=cuda).to(y.dtype)
    args = [x[k] for k in NAMES]
    got = scan_cuda.selective_scan_bwd(*args, states, gy, delta_softplus=True,
                                       compute=BF16, **kw)
    want = selective_scan_bwd_ref(*args, want_states, gy,
                                  delta_softplus=True, compute=BF16, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _rel_close(g, w, 1e-2 if g.dtype == torch.bfloat16 else 1e-4)
    return args, states, gy, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", sorted(EDGE_SHAPES))
def test_bf16_mode_backward_matches_plain_version_at_edge_shapes(
        cuda, shape, reverse, dtype):
    kw = dict(EDGE_SHAPES[shape])
    if reverse:
        kw["reverse_dirs"] = (True, True)
    if dtype == "bfloat16":
        kw.update(dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    _bf16_backward(cuda, kw)


def _bf16_hillis(cuda, case, dtype, width="narrow", batch=None):
    """K3 and K4 in the mode against their plain versions."""
    kw = dict(case)
    skip = kw.pop("skip", True)
    valid_len = kw.pop("valid_len", None)
    dpg = kw.get("dpg", 24)
    if width == "wide":
        kw["b"] = -(-132 // (2 * -(-dpg // 32)))
    if batch is not None:
        kw["b"] = batch
    x = _inputs(cuda, dtype=getattr(torch, dtype), **kw)
    if not skip:
        x["D"] = x["delta_bias"] = None
    args = [x[k] for k in NAMES]
    vkw = dict(delta_softplus=True, valid_len=valid_len, compute=BF16)
    got = scan_hillis.selective_scan_hillis_fwd(*args, **vkw)
    want = selective_scan_hillis_ref(*args, **vkw)
    torch.cuda.synchronize()
    for part, g, w in zip(("y", "states", "last"), got, want):
        assert g.dtype == w.dtype == torch.float32, part
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(4)
    gy = torch.randn(got[0].shape, generator=gen, device=cuda)
    grads = scan_hillis.selective_scan_hillis_bwd(*args, got[1], gy, **vkw)
    want = selective_scan_hillis_bwd_ref(*args, got[1], gy, **vkw)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, grads, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _rel_close(g, w, 1e-2 if g.dtype == torch.bfloat16 else 1e-4)
    return args, got, gy, vkw


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(HILLIS_FWD_EDGES))
def test_bf16_mode_hillis_forward_matches_plain_version_at_edge_shapes(
        cuda, shape, dtype, width):
    """K3 in the mode, and K4 from its chunk states: the state carried in
    bfloat16 comes out the plain version's bits in practice; 1e-4 holds."""
    _bf16_hillis(cuda, HILLIS_FWD_EDGES[shape], dtype, width)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(HILLIS_BWD_EDGES))
def test_bf16_mode_hillis_backward_matches_plain_version_at_edge_shapes(
        cuda, shape, dtype):
    _bf16_hillis(cuda, HILLIS_BWD_EDGES[shape], dtype, batch=2)


@pytest.mark.parametrize("stage", range(len(STAGE_SHAPES)))
def test_bf16_mode_at_the_stage_shapes_at_batch_1(cuda, stage):
    """K1 + K2 and K3 + K4 in the mode at each medmamba_t stage shape at
    batch 1 (8-channel blocks in the forward): a demo request's shapes."""
    dpg, l = STAGE_SHAPES[stage]
    _bf16_backward(cuda, dict(b=1, dpg=dpg, l=l,
                              reverse_dirs=(False, True)))
    _bf16_hillis(cuda, dict(dpg=dpg, l=l), "float32", batch=1)


@pytest.mark.parametrize("scan", ["ssd", "hillis"])
def test_bf16_mode_backward_is_deterministic(cuda, scan):
    """K2 and K4 in the mode give the same bits on every launch."""
    if scan == "ssd":
        args, states, gy, kw = _bf16_backward(
            cuda, dict(dpg=40, l=200, reverse_dirs=(False, True)))
        first, second = (scan_cuda.selective_scan_bwd(
            *args, states, gy, delta_softplus=True, compute=BF16, **kw)
            for _ in range(2))
    else:
        args, fwd, gy, vkw = _bf16_hillis(
            cuda, dict(dpg=40, l=200, valid_len=180), "float32", batch=3)
        first, second = (scan_hillis.selective_scan_hillis_bwd(
            *args, fwd[1], gy, **vkw) for _ in range(2))
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


def test_bf16_mode_moves_the_kernels(cuda):
    """The mode is live on the card: K1's and K3's y, K2's and K4's
    gradients differ from the float32 instantiations' by at least 1e-3 of
    scale; dD, which no rounding reaches, keeps its bits."""
    x = _inputs(cuda, dpg=40, l=200)
    args = [x[k] for k in NAMES]
    kw = dict(delta_softplus=True, reverse_dirs=(False, True))
    out = {}
    for compute in ("float32", BF16):
        y, _, states = scan_cuda.selective_scan_fwd(
            **x, return_states=True, compute=compute, **kw)
        gy = torch.ones_like(y)
        g = scan_cuda.selective_scan_bwd(*args, states, gy, compute=compute,
                                         **kw)
        yh, hst, _ = scan_hillis.selective_scan_hillis_fwd(
            *args, delta_softplus=True, compute=compute)
        gh = scan_hillis.selective_scan_hillis_bwd(
            *args, hst, gy, delta_softplus=True, compute=compute)
        out[compute] = (y, g, yh, gh)
    torch.cuda.synchronize()
    f32, b16 = out["float32"], out[BF16]
    for i in (0, 2):
        scale = f32[i].abs().max()
        assert (b16[i] - f32[i]).abs().max() >= 1e-3 * scale
    for i in (1, 3):
        for name, a, b in zip(NAMES, b16[i], f32[i]):
            if name == "D":
                assert torch.equal(a, b)
            else:
                assert (a - b).abs().max() >= 1e-3 * b.abs().max(), name


@pytest.mark.parametrize("scan", ["ssd", "hillis"])
def test_selector_runs_the_bf16_mode_forward_and_backward(cuda, scan,
                                                          monkeypatch):
    """Under MEDMAMBA_SCAN_COMPUTE=bfloat16 the dispatcher's autograd path
    gives the plain versions' y and gradients in the mode (K2's: the
    explicit adjoint, not autograd through the plain scan's roundings), and
    the backward keeps the forward's mode after the variable is unset; its
    no-grad path (the graph op) gives the kernel's bits in the mode."""
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", scan)
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", BF16)
    x = _inputs(cuda)
    xk = {k: v.clone().requires_grad_(True) for k, v in x.items()}
    kw = dict(delta_softplus=True, reverse_dirs=(False, True))
    y = selective_scan(**xk, **kw)
    monkeypatch.delenv("MEDMAMBA_SCAN_COMPUTE")
    gy = torch.randn(y.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(5), device=cuda)
    y.backward(gy)
    args = [x[k] for k in NAMES]
    if scan == "ssd":
        yr = ss._plain_scan(*args, True, False, (False, True), 1, None,
                            None, BF16)
        states = selective_scan_states_ref(
            *args[:5], x["delta_bias"], True, (False, True), compute=BF16)
        want = selective_scan_bwd_ref(*args, states, gy, delta_softplus=True,
                                      reverse_dirs=(False, True),
                                      compute=BF16)
    else:
        xr = {k: v.clone().requires_grad_(True) for k, v in x.items()}
        yr = ss._hillis_scan(*(xr[k] for k in NAMES), True, False,
                             (False, True), 1, None,
                             selective_scan_hillis_ref,
                             selective_scan_hillis_bwd_ref, BF16)
        yr.backward(gy)
        want = [xr[k].grad for k in NAMES]
    torch.testing.assert_close(y.detach(), yr.detach(), rtol=1e-4,
                               atol=1e-4)
    for k, w in zip(NAMES, want):
        _rel_close(xk[k].grad, w, 1e-4)
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", BF16)
    with torch.no_grad():
        got = selective_scan(**x, **kw)
    if scan == "ssd":
        want = scan_cuda.selective_scan_fwd(**x, compute=BF16, **kw)[0]
    else:
        want = ss._hillis_scan(*(x[k] for k in NAMES), True, False,
                               (False, True), 1, None,
                               scan_hillis.selective_scan_hillis_fwd,
                               scan_hillis.selective_scan_hillis_bwd, BF16)
    assert torch.equal(got, want)


def test_exported_model_keeps_the_bf16_mode(cuda, monkeypatch):
    """A tiny VSSM exported on the card under the mode: its scan nodes
    carry it, and the artifact, called with the variable unset, gives the
    live forward's probabilities in the mode."""
    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.utils.export import export_forward, load_exported

    model = tv.VSSM(num_classes=3, depths=(1, 2), dims=(16, 32)).eval()
    monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", BF16)
    exp = load_exported(export_forward(model, image_size=32, device="cuda"))
    model = model.to(cuda)
    x = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.no_grad():
        want = torch.softmax(model(preprocess(x, size=32)), -1)
    monkeypatch.delenv("MEDMAMBA_SCAN_COMPUTE")
    assert exp.scan_compute() == [BF16] * 6
    torch.testing.assert_close(exp.call(x), want, rtol=1e-5, atol=1e-5)


def test_float32_instantiations_keep_the_earlier_builds_bits(cuda):
    """The float32 mode of K1-K4 against the sources of the commit before
    the mode, written into ``_build/earlier`` as
    ``tools/earlier_kernels.py`` says: the same registers for every
    float32 instantiation and the same bits at the medmamba_t stage
    shapes."""
    import os

    from medmamba_tpu_torch.ops import cuda_build
    from medmamba_tpu_torch.tools import earlier_kernels

    src = os.path.join(cuda_build.BUILD_DIR, "earlier")
    if not os.path.isfile(os.path.join(src, scan_cuda.FWD_SOURCE)):
        pytest.skip(f"no earlier sources in {src}")
    assert earlier_kernels.main(["--dir", src, "--no_timing"]) == 0


# --- the compiled steps (utils/graphs.py): CUDA graphs against eager ------

GRAPH_VSSM = dict(num_classes=5, depths=(1, 2), dims=(32, 64))


def _graph_model(cuda, **kw):
    return tv.VSSM(**GRAPH_VSSM, generator=torch.Generator().manual_seed(0),
                   **kw).to(cuda)


def _frames(cuda, b, size=64, seed=0):
    return torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed)
                         ).to(cuda)


@pytest.mark.parametrize("batch", [64, 3, 1])
def test_graph_forward_gives_the_eager_bits(cuda, batch):
    """The graphed softmax forward equals the eager one bit for bit, from a
    host batch as from a device batch, and counts the eager launches (2 K1
    a block) per replay and none for its warm-up."""
    from medmamba_tpu_torch.train import trainer

    model = _graph_model(cuda)
    x = _frames(cuda, batch)
    want, want_x = trainer.predict(model, x, image_size=64)
    forward = trainer.compile_forward(model)
    scan_cuda.LAUNCHES = 0
    for inp in (x, x.cpu()):
        got, got_x = forward(inp, image_size=64)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_x, want_x)
    assert scan_cuda.LAUNCHES == 2 * 6 and len(forward.graphs) == 1
    forward.free()


def _train_runs(cuda, scan, monkeypatch, steps=3, **model_kw):
    """``steps`` steps eagerly twice and graphed once from one state and
    one generator seed: (losses, state dict) of each."""
    import functools

    from medmamba_tpu_torch.train import trainer

    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", scan)
    model = _graph_model(cuda, drop_path_rate=0.3, **model_kw)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    x, labels = _frames(cuda, 6, seed=1), torch.tensor([0, 1, 2, 3, 4, -1],
                                                       device=cuda)
    runs = []
    for graphed in (False, False, True):
        model.load_state_dict(state)
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        gen = torch.Generator(device=cuda)
        step = (trainer.compile_train_step(model, opt, generator=gen)
                if graphed else functools.partial(trainer.train_step, model,
                                                  opt, generator=gen))
        gen.manual_seed(7)
        losses = torch.stack([
            step(x, labels, augment=True, image_size=64).clone()
            for _ in range(steps)])
        runs.append((losses, {k: v.clone()
                              for k, v in model.state_dict().items()}))
    step.free()
    return runs


@pytest.mark.parametrize("scan", ["ssd", "hillis"])
@pytest.mark.parametrize("remat", [False, True])
def test_graph_train_step_matches_eager(cuda, scan, remat, monkeypatch):
    """Three steps with augmentation and drop path: where two eager runs
    agree bit for bit, the graphed steps give their bits; else each loss
    within 1e-4 of its scale. With ``use_checkpoint`` too."""
    (l1, s1), (l2, s2), (lg, sg) = _train_runs(
        cuda, scan, monkeypatch, use_checkpoint=remat)

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)
    if torch.equal(l1, l2) and same(s1, s2):
        assert torch.equal(lg, l1) and same(sg, s1)
    else:
        assert ((lg - l1).abs() / l1.abs().clamp_min(1)).max() <= 1e-4


def test_graph_draws_what_eager_draws_after_manual_seed(cuda):
    """A graph registered with a generator draws, after ``manual_seed``,
    what eager calls draw from the same seed, and advances it as they do."""
    from medmamba_tpu_torch.data.transforms import random_augment
    from medmamba_tpu_torch.utils import graphs

    model = torch.nn.Linear(2, 2).to(cuda)
    gen = torch.Generator(device=cuda)
    x = torch.rand(4, 16, 16, 3, device=cuda) * 255

    def draw(img):
        return random_augment(img, gen), torch.rand(5, generator=gen,
                                                    device=cuda)
    gen.manual_seed(11)
    want = [[t.clone() for t in draw(x)] for _ in range(2)]
    graph = graphs.Graph(draw, (x,), label="draw", model=model,
                         generators=[gen])
    gen.manual_seed(11)
    got = [[t.clone() for t in graph(x)] for _ in range(2)]
    for w, g in zip(want, got):
        assert all(torch.equal(a, b) for a, b in zip(w, g))
    assert not torch.equal(got[0][1], got[1][1])


def test_graph_recaptures_when_a_scan_variable_changes(cuda, monkeypatch):
    """Each setting of MEDMAMBA_SCAN_KERNEL / MEDMAMBA_SCAN_COMPUTE gets its
    own graph, which launches its own kernel; going back replays the first
    graph."""
    from medmamba_tpu_torch.train import trainer

    model = _graph_model(cuda)
    x = _frames(cuda, 2)
    forward = trainer.compile_forward(model)
    counts = []
    for kernel, compute in (("ssd", "float32"), ("hillis", "float32"),
                            ("hillis", "bfloat16"), ("ssd", "float32")):
        monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", kernel)
        monkeypatch.setenv("MEDMAMBA_SCAN_COMPUTE", compute)
        want = trainer.predict(model, x, image_size=64)[0]
        scan_cuda.LAUNCHES = scan_hillis.HILLIS_LAUNCHES = 0
        got = forward(x, image_size=64)[0]
        counts.append((scan_cuda.LAUNCHES, scan_hillis.HILLIS_LAUNCHES))
        assert torch.equal(got, want), (kernel, compute)
    assert counts == [(6, 0), (0, 6), (0, 6), (6, 0)]
    assert len(forward.graphs) == 3
    forward.free()


def test_graph_state_guard_raises_after_load_state_dict(cuda):
    import copy

    from medmamba_tpu_torch.train import trainer

    model = _graph_model(cuda)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    step = trainer.compile_train_step(
        model, opt, generator=torch.Generator(device=cuda).manual_seed(0))
    x, y = _frames(cuda, 2), torch.tensor([0, 1], device=cuda)
    step(x, y, augment=True, image_size=64)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    with pytest.raises(RuntimeError, match="optimizer state"):
        step(x, y, augment=True, image_size=64)
    step.free()


def _cam_bits(model, cam, x, **kw):
    """The graphed CAM ``cam`` of ``model`` against the eager ``grad_cam``
    bit for bit where two eager CAMs agree; else, and then only, a graph
    captured under cuDNN's deterministic algorithms against the eager CAM
    there. Returns the graphed CAM."""
    from medmamba_tpu_torch.eval.gradcam import compile_cam, grad_cam

    want, again = grad_cam(model, x, **kw), grad_cam(model, x, **kw)
    got = cam(x, **kw)
    if np.array_equal(want, again):
        np.testing.assert_array_equal(got, want)
        return got
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = compile_cam(model)
        np.testing.assert_array_equal(det(x, **kw), grad_cam(model, x, **kw))
        det.step.free()
    finally:
        torch.backends.cudnn.deterministic = old
    return got


@pytest.mark.parametrize("scan", ["ssd", "hillis"])
def test_graph_cam_gives_the_eager_bits_with_exact_launches(cuda, scan,
                                                            monkeypatch):
    """The graphed Grad-CAM (``compile_cam``) against the eager
    ``grad_cam`` on the same model: at the default target (6 forward
    launches, no backward), with the class taken on the card, at two
    targets upstream of 4 scans, and with ``substitute`` at a target and a
    block's output; bit for bit where two eager CAMs agree (else under
    ``cudnn.deterministic``), and the eager launches per replay."""
    from medmamba_tpu_torch.eval.gradcam import (compile_cam,
                                                 target_activations)

    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", scan)
    model = _graph_model(cuda).eval()
    x = torch.randn(2, 64, 64, 3, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    cam = compile_cam(model)
    up = ["layers_0.blocks_0.conv1x1", "layers_1.blocks_1.conv1x1"]
    sites = [up[0], "layers_0.blocks_0"]
    cases = [(dict(target_class=[1, 4]), 0), (dict(), 0),
             (dict(target_class=[0, 2], target_paths=up), 4),
             (dict(target_class=[3, 3], target_paths=up[:1],
                   substitute=dict(zip(sites, target_activations(
                       model, x, sites)))), 4)]
    for kw, n_bwd in cases:
        got = _cam_bits(model, cam, x, **kw)
        assert got.shape == (2, 64, 64) and got.max() - got.min() > 0.5
        scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = 0
        scan_hillis.HILLIS_LAUNCHES = scan_hillis.HILLIS_BWD_LAUNCHES = 0
        cam(x, **kw)
        counts = (scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES,
                  scan_hillis.HILLIS_LAUNCHES,
                  scan_hillis.HILLIS_BWD_LAUNCHES)
        assert counts == ((6, n_bwd, 0, 0) if scan == "ssd"
                          else (0, 0, 6, n_bwd)), (kw, counts)
    assert len(cam.step.graphs) == len(cases)
    assert all(not m.taps for m in model.modules() if hasattr(m, "taps"))
    assert all(p.requires_grad for p in model.parameters())
    cam.step.free()


def test_graph_cam_keeps_at_most_its_bound(cuda, monkeypatch):
    """Past CAM_GRAPHS signatures the least recently used graph is freed
    and a call at its shape captures it again, with the same bits."""
    from medmamba_tpu_torch.eval import gradcam

    monkeypatch.setattr(gradcam, "CAM_GRAPHS", 2)
    model = _graph_model(cuda).eval()
    cam = gradcam.compile_cam(model)
    xs = [torch.randn(b, 64, 64, 3, device=cuda) for b in (1, 2, 3)]
    first = cam(xs[0], target_class=[0])
    for x in xs[1:]:
        cam(x, target_class=[0] * x.shape[0])
    assert len(cam.step.graphs) == 2
    np.testing.assert_array_equal(cam(xs[0], target_class=[0]), first)
    assert len(cam.step.graphs) == 2
    cam.step.free()


def test_graph_exported_forward_gives_the_eager_artifacts_bits(cuda):
    """``Exported.call`` on the card replays one graph per batch: the eager
    artifact's bits (the loaded module run op by op), the live forward's
    probabilities within 1e-5, 2 K1 a block a call, and a tensor of its
    own that the next call does not overwrite."""
    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.utils.export import export_forward, load_exported

    model = _graph_model(cuda).eval()
    exp = load_exported(export_forward(model, image_size=64, device="cuda"))
    x = _frames(cuda, 64, seed=2)
    kept = []
    for b in (64, 3, 1):
        with torch.no_grad():
            eager = exp._module(x[:b])
            live = torch.softmax(model(preprocess(x[:b], size=64)), -1)
        scan_cuda.LAUNCHES = 0
        got = exp.call(x[:b])
        torch.cuda.synchronize()
        assert scan_cuda.LAUNCHES == 6, (b, scan_cuda.LAUNCHES)
        assert torch.equal(got, eager), b
        torch.testing.assert_close(got, live, rtol=1e-5, atol=1e-5)
        kept.append((got, eager))
    exp.call(x[:3].flip(0))
    assert all(torch.equal(g, e) for g, e in kept)
    assert len(exp.graphs.graphs) == 3


# medmamba_b's scan shapes at 224^2: channels per group and length
B_STAGE_SHAPES = [(128, 3136), (256, 784), (512, 196), (1024, 49)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("stage", range(len(B_STAGE_SHAPES)))
def test_kernels_match_plain_versions_at_medmamba_b_shapes(cuda, stage,
                                                           batch, dtype):
    """K1 (y, the last state, the tile-entry states) and K2 forward and
    reverse, K3 and K4, against their plain versions at medmamba_b's stage
    shapes, at batch 64 (K1's 32-channel blocks) and 1 (8-channel
    blocks)."""
    dpg, l = B_STAGE_SHAPES[stage]
    dt = getattr(torch, dtype)
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    for rev in ((False, False), (True, True)):
        x = _inputs(cuda, b=batch, dpg=dpg, l=l, dtype=dt)
        got = selective_scan(**x, delta_softplus=True, reverse_dirs=rev,
                             out_dtype=dt, return_last_state=True)
        want = selective_scan(**x, delta_softplus=True, reverse_dirs=rev,
                              out_dtype=dt, return_last_state=True,
                              impl="ref")
        torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        del x, got, want
        _check_backward(cuda, dict(b=batch, dpg=dpg, l=l, dtype=dt,
                                   out_dtype=dt, reverse_dirs=rev))
    x = _inputs(cuda, b=batch, dpg=dpg, l=l, dtype=dt)
    args = [x[k] for k in NAMES]
    got = scan_hillis.selective_scan_hillis_fwd(*args, delta_softplus=True)
    want = selective_scan_hillis_ref(*args, delta_softplus=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    gy = torch.randn(got[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5))
    grads = scan_hillis.selective_scan_hillis_bwd(*args, want[1], gy,
                                                  delta_softplus=True)
    wants = selective_scan_hillis_bwd_ref(*args, want[1], gy,
                                          delta_softplus=True)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, grads, wants):
        _rel_close(g, w, 1e-2 if g.dtype == torch.bfloat16 else 1e-4)


def test_graph_replay_kernels_seen_by_the_profiler(cuda):
    """One train replay in the profiler: 2 K1 and 2 K2 launches a block
    (K2 two kernels a launch) and one K5, as the counters say."""
    from torch.profiler import ProfilerActivity, profile

    from medmamba_tpu_torch.train import trainer

    model = _graph_model(cuda)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    step = trainer.compile_train_step(
        model, opt, generator=torch.Generator(device=cuda).manual_seed(0))
    x, y = _frames(cuda, 2), torch.tensor([0, 1], device=cuda)
    step(x, y, augment=True, image_size=64)
    scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = rotate.LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y, augment=True, image_size=64)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = [sum(1 for n in names if p in n) for p in (
        "scan_fwd_kernel", "scan_bwd_kernel", "scan_bwd_reduce_kernel",
        "rotate_flip_kernel")]
    assert seen == [6, 6, 6, 1], seen
    assert (scan_cuda.LAUNCHES, scan_cuda.BWD_LAUNCHES,
            rotate.LAUNCHES) == (6, 6, 1)
    step.free()


def test_graph_train_cli_profile_dir_traces_the_replays(cuda, tmp_path):
    """``cli.train --profile_dir`` on the card: the trace of steps 3-5,
    all replays, holds their kernels. The host runs up to two replays
    ahead of the card, so the window the card's kernels fall in is not
    exactly steps 3-5: at least one replay's kernels and at most all five
    steps'."""
    import json
    import os

    from medmamba_tpu_torch.cli import train as train_cli

    rng = np.random.default_rng(0)
    for split, n in (("train", 10), ("val", 2)):
        np.save(tmp_path / f"{split}_images.npy",
                rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8))
        np.save(tmp_path / f"{split}_labels.npy",
                (np.arange(n) % 3).reshape(n, 1).astype(np.int64))
    prof = tmp_path / "prof"
    train_cli.main(["--train_dir", str(tmp_path), "--val_dir",
                    str(tmp_path), "--batch_size", "2", "--epochs", "1",
                    "--image_size", "32", "--augmentation", "--save_dir",
                    str(tmp_path / "run"), "--log_every", "0",
                    "--profile_dir", str(prof)])
    with open(os.path.join(prof, "trace.json")) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    k1 = sum("scan_fwd_kernel" in n for n in names)
    k2 = sum("scan_bwd_kernel" in n for n in names)
    k5 = sum("rotate_flip_kernel" in n for n in names)
    assert 20 <= k1 <= 5 * 20 and 20 <= k2 <= 5 * 20 and 1 <= k5 <= 5


@pytest.mark.parametrize("arch", ["vit", "swin", "mobilenet"])
def test_backbone_logits_on_the_card_match_the_cpu(cuda, arch):
    """``cli.cam_backbones``' models at full width (ViT-B/16, Swin-T,
    MobileNetV2; the ViT's zero head drawn from normal(0.02)) at 64^2: the
    card's logits within 1e-4 of their scale of the CPU's."""
    from medmamba_tpu_torch.cli.cam_backbones import build

    gen = torch.Generator().manual_seed(0)
    model, _, _ = build(arch, 10, 64, gen)
    if arch == "vit":
        with torch.no_grad():
            model.head.weight.normal_(0.0, 0.02, generator=gen)
    model.eval()
    x = torch.randn(2, 64, 64, 3, generator=gen)
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_vssmseg_launches_the_kernels_once_per_scan(cuda):
    """The default VSSMSeg (20 SS-Conv-SSM blocks) at 64^2: 40 K1 a
    forward, against the plain scan to 1e-4 of its scale; 40 K2 a
    backward."""
    from medmamba_tpu_torch.models.decoder import VSSMSeg

    model = VSSMSeg(2).to(cuda).eval()
    ref = VSSMSeg(2, scan_impl="ref").to(cuda).eval()
    ref.load_state_dict(model.state_dict())
    x = torch.randn(2, 64, 64, 3, device=cuda)
    scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = 0
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert scan_cuda.LAUNCHES == 40
        want = ref(x)
    assert got.shape == (2, 64, 64, 2)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    model(x).square().mean().backward()
    torch.cuda.synchronize()
    assert scan_cuda.LAUNCHES == 80 and scan_cuda.BWD_LAUNCHES == 40


@pytest.mark.parametrize("scan", ["ssd", "hillis"])
def test_kernel_path_refuses_a_gradient_through_the_last_state(cuda, scan,
                                                               monkeypatch):
    """K2 and K4 give y's gradient only: a loss that uses the last state
    raises in the backward (it lost that gradient without a word before);
    through y alone the gradients are the plain scan's, to 1e-4 of each
    one's scale."""
    monkeypatch.setenv("MEDMAMBA_SCAN_KERNEL", scan)
    x = _inputs(cuda, b=2, dpg=8, l=150)
    gy = torch.randn(x["delta"].shape, device=cuda)

    def leaves():
        return {k: v.clone().requires_grad_() for k, v in x.items()}
    args = leaves()
    y, last = selective_scan(**args, delta_softplus=True,
                             return_last_state=True)
    with pytest.raises(RuntimeError, match="last state"):
        ((y * gy).sum() + last.sum()).backward()
    args = leaves()
    y, _ = selective_scan(**args, delta_softplus=True, return_last_state=True)
    (y * gy).sum().backward()
    want = leaves()
    (selective_scan(**want, delta_softplus=True, impl="ref") * gy
     ).sum().backward()
    for k in x:
        ref = want[k].grad
        assert (args[k].grad - ref).abs().max() <= 1e-4 * ref.abs().max(), k


def test_distributed_world1_nccl_graphed_step_gives_the_eager_bits(
        cuda, tmp_path, monkeypatch):
    """A world-1 NCCL group: the train step captured with its collectives
    (the loss's count, the flat gradient sum) as a CUDA graph gives the
    bits of the eager step without a group, over 3 steps (bf16 blocks, a
    tiny VSSM at 32^2, augmentation)."""
    from medmamba_tpu_torch.parallel import mesh
    from medmamba_tpu_torch.train import trainer

    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    kw = dict(num_classes=3, depths=(1, 2), dims=(16, 32),
              dtype=torch.bfloat16)
    state = tv.VSSM(**kw).state_dict()
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (8, 32, 32, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    labels = torch.tensor([0, 1, 2, 0, 1, 2, -1, -1], device="cuda")

    def run(graphed):
        model = tv.VSSM(**kw).to(cuda)
        model.load_state_dict(state)
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        g = torch.Generator(device="cuda").manual_seed(1)
        if graphed:
            step = trainer.compile_train_step(model, opt, generator=g)
            losses = [step(images, labels, augment=True,
                           image_size=32).clone() for _ in range(3)]
            step.free()
        else:
            losses = [trainer.train_step(model, opt, images, labels,
                                         generator=g, augment=True,
                                         image_size=32) for _ in range(3)]
        return torch.stack(losses), model.state_dict()

    eager_losses, eager_state = run(False)
    grid = mesh.make_mesh(device="cuda", rank=0, world_size=1,
                          init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        assert torch.distributed.get_backend(mesh.data_group(grid)) == "nccl"
        graph_losses, graph_state = run(True)
    finally:
        mesh.destroy_mesh()
    assert torch.equal(graph_losses, eager_losses)
    for k, v in eager_state.items():
        assert torch.equal(graph_state[k], v), k


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")
    from medmamba_tpu_torch.ops import cuda_build

    # built once here, so that the ranks load it and never race a build
    cuda_build.build(scan_cuda.FWD_SOURCE, scan_cuda.BWD_SOURCE,
                     rotate.SOURCE)
    return torch.cuda.device_count()


def test_distributed_graphed_steps_across_cards(cuda, tmp_path,
                                                monkeypatch):
    """One NCCL rank a card (every card of the machine, at least two): the
    train step captured as a CUDA graph with its collectives gives the
    eager step's bits under the same group over 3 steps, and the graphed
    eval step the eager summed count; the ranks hold the same state; the
    first step's loss within 1e-2 of one process's on the whole batch
    (bf16 blocks: the ranks' kernels run smaller batches and round their
    bfloat16 outputs apart). A tiny VSSM at 32^2, global batch 8 with two
    padding rows, so at four ranks the last rank holds no valid row."""
    import torch_port_ranks as ranks

    from medmamba_tpu_torch.train import trainer

    world = _cards(2)
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    kw = dict(num_classes=3, depths=(1, 2), dims=(16, 32),
              dtype=torch.bfloat16)
    weights = tv.VSSM(**kw).state_dict()
    gen = torch.Generator().manual_seed(0)
    batch = 2 * world
    images = torch.randint(0, 256, (batch, 32, 32, 3), generator=gen,
                           dtype=torch.uint8)
    labels = torch.arange(batch) % 3
    labels[-2:] = -1
    got = ranks.spawn(ranks.graphed_steps, world, tmp_path, kw, weights,
                      images, labels, 3, 32, device="cuda", backend="nccl")
    for g in got:
        assert torch.equal(g["graphed"]["losses"], g["eager"]["losses"])
        assert g["graphed"]["correct"] == g["eager"]["correct"]
        for k, v in g["eager"]["state"].items():
            assert torch.equal(g["graphed"]["state"][k], v), k
            assert torch.equal(got[0]["graphed"]["state"][k], v), k
    model = tv.VSSM(**kw).to(cuda)
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    want = trainer.train_step(
        model, opt, images.to(cuda), labels.to(cuda), augment=True,
        generator=torch.Generator(device="cuda").manual_seed(1),
        image_size=32).item()
    for g in got:
        assert abs(g["graphed"]["losses"][0].item() - want) <= 1e-2 * abs(
            want)


def test_distributed_train_cli_across_cards(cuda, tmp_path, monkeypatch):
    """``cli.train --device cuda`` (graphed steps) with one NCCL rank a
    card against one process: rank 0 alone writes the same files, and the
    first step's loss agrees to 1e-4 relative (float32; medmamba_t at
    32^2, 2 rows a rank, the last global row padding)."""
    import os

    import torch_port_ranks as ranks

    from medmamba_tpu_torch.cli import train as train_cli

    world = _cards(2)
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    rng = np.random.default_rng(0)
    n = 2 * world - 1
    data = tmp_path / "d"
    data.mkdir()
    for split in ("train", "val"):
        np.save(data / f"{split}_images.npy",
                rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8))
        np.save(data / f"{split}_labels.npy",
                (np.arange(n) % 3).reshape(n, 1).astype(np.int64))

    def argv(run):
        return ["--train_dir", str(data), "--val_dir", str(data),
                "--batch_size", str(2 * world), "--epochs", "1",
                "--image_size", "32", "--augmentation", "--device", "cuda",
                "--save_dir", str(tmp_path / run), "--log_every", "0"]
    want = train_cli.main(argv("one"))["step_losses"]
    got = ranks.spawn(ranks.train_cli, world, tmp_path, argv("ranks"),
                      device="cuda", backend="nccl")
    assert [g["writes"] for g in got] == [3] + [0] * (world - 1)
    assert sorted(os.listdir(tmp_path / "ranks")) == sorted(
        os.listdir(tmp_path / "one"))
    for g in got:
        assert len(g["step_losses"]) == len(want) == 1
        assert abs(g["step_losses"][0].item() - want[0]) <= 1e-4 * abs(
            want[0])


def test_seq_parallel_on_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """The split scan over 2 ranks on one card (gloo; NCCL refuses two
    ranks on one card): one K1 launch a rank, y and the final state
    against K1 over the whole sequence to 1e-4 of their scale, and a
    backward through the kernel path raises."""
    import torch_port_ranks as ranks

    x = {k: v.cpu() for k, v in _inputs(cuda, b=2, dpg=24, l=256).items()}
    got = ranks.spawn(ranks.seq_scan_cuda, 2, tmp_path, x, device="cuda:0")
    with torch.no_grad():
        y, h = selective_scan(**{k: v.to(cuda) for k, v in x.items()},
                              delta_softplus=True, return_last_state=True)
    y, h = y.cpu(), h.cpu()
    assert [g["launches"] for g in got] == [1, 1]
    got_y = torch.cat([g["y"] for g in got], dim=-1)
    assert (got_y - y).abs().max() <= 1e-4 * y.abs().max()
    for g in got:
        assert (g["h"] - h).abs().max() <= 1e-4 * h.abs().max()
        assert "last state" in g["raised"]


@pytest.mark.parametrize("grid", ["2x2", "1x4"])
def test_tensor_parallel_graphed_steps_across_cards(cuda, tmp_path,
                                                    monkeypatch, grid):
    """Four cards, one NCCL rank a card, as a ("data", "model") mesh of
    ``grid``: medmamba_t at 224^2, partitioned, a global batch of 64,
    float32 under ``cudnn.deterministic``, augmentation. The train step
    captured as a CUDA graph with both groups' collectives gives the eager
    TP step's bits over 3 steps; every rank launches 20 K1 + 20 K2 a step,
    each on 64 / (n_data * n_model) rows; the first loss within 1e-4 of
    one process's on the whole batch."""
    import torch_port_ranks as ranks

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train import trainer

    if _cards(4) != 4:
        pytest.skip("the meshes are 2x2 and 1x4: four cards")
    n_data, n_model = (int(v) for v in grid.split("x"))
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (64, 224, 224, 3), generator=gen,
                           dtype=torch.uint8)
    labels = torch.randint(0, 9, (64,), generator=gen)
    torch.backends.cudnn.deterministic = True
    try:
        model = create_model("T", 9, device=cuda,
                             generator=torch.Generator().manual_seed(0))
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        want = trainer.train_step(
            model, opt, images.to(cuda), labels.to(cuda), augment=True,
            generator=torch.Generator(device=cuda).manual_seed(1),
            image_size=224).item()
    finally:
        torch.backends.cudnn.deterministic = False
    del model, opt
    torch.cuda.empty_cache()
    steps = 3
    got = ranks.spawn(ranks.tp_graphed_steps, 4, tmp_path, images, labels,
                      steps, 9, device="cuda", backend="nccl",
                      n_model=n_model)
    rows = 64 // (n_data * n_model)
    for g in got:
        assert torch.equal(g["graphed"]["losses"], g["eager"]["losses"])
        for k, v in g["eager"]["state"].items():
            assert torch.equal(g["graphed"]["state"][k], v), k
        for run in ("eager", "graphed"):
            c = g[run]["counts"]
            assert c["scan_cuda.LAUNCHES"] == 20 * steps, (run, c)
            assert c["scan_cuda.BWD_LAUNCHES"] == 20 * steps, (run, c)
        assert g["rows"] == [rows] * (40 * steps)
        assert abs(g["eager"]["losses"][0].item() - want) <= 1e-4 * abs(want)


# --- tracing (utils/tracing.py): markers, spans and counters on the card --


def _traced_replays(step, *args, **static):
    """Two replays of a captured step under the profiler: (marker names
    with their start and end, K2 kernels, the ``medmamba.*`` events with
    their device types, the ``medmamba.graph.launch`` spans' starts), the
    times in µs on the profiler's one clock."""
    from torch.profiler import ProfilerActivity, profile

    from medmamba_tpu_torch.utils import tracing

    kernels = {tracing.kernel_name(m): m for m in tracing.MARKERS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(*args, **static)
        torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    cuda_type = torch.autograd.DeviceType.CUDA
    marks = [(kernels[e.name], e.time_range.start, e.time_range.end)
             for e in events
             if e.device_type == cuda_type and e.name in kernels]
    k2 = [(e.time_range.start, e.time_range.end) for e in events
          if e.device_type == cuda_type and "scan_bwd" in e.name]
    spans = [(e.name, e.device_type) for e in events
             if e.name.startswith("medmamba.")]
    launches = [e.time_range.start for e in events
                if e.name == "medmamba.graph.launch"]
    return marks, k2, spans, launches


def test_tracing_markers_of_a_replayed_train_step_in_order(cuda):
    """Two replays of the graphed train step: each brings its six markers
    less ``step.exchange`` (no data group) in order; every K2 kernel runs
    between ``step.backward`` and ``step.optimizer``; the ``medmamba.*``
    spans are host events; each replay's ``graph.launch`` span starts
    before its ``step.begin`` marker on the card (one clock); the
    counters count one capture and three replays, and the node gauge
    holds the graph's nodes."""
    from medmamba_tpu_torch.train import trainer
    from medmamba_tpu_torch.utils import tracing

    model = _graph_model(cuda)
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    step = trainer.compile_train_step(
        model, opt, generator=torch.Generator(device=cuda).manual_seed(0))
    x, y = _frames(cuda, 2), torch.tensor([0, 1], device=cuda)
    before = tracing.snapshot()
    step(x, y, augment=True, image_size=64)
    marks, k2, spans, launches = _traced_replays(step, x, y, augment=True,
                                                 image_size=64)
    after = tracing.snapshot()
    order = ["step.begin", "step.forward", "step.backward",
             "step.optimizer", "step.end"]
    assert [m for m, _, _ in marks] == order * 2
    for r in range(2):
        start = {m: s for m, s, _ in marks[5 * r:5 * r + 5]}
        inside = [(s, e) for s, e in k2
                  if start["step.begin"] <= s < start["step.end"]]
        assert len(inside) == 2 * 6      # walk and reduction, 6 launches
        assert all(start["step.backward"] <= s and e <= start[
            "step.optimizer"] for s, e in inside)
        assert launches[r] < start["step.begin"]
    assert len(k2) == 2 * 2 * 6
    assert spans and all(d != torch.autograd.DeviceType.CUDA
                         for _, d in spans)
    names = {n for n, _ in spans}
    assert {"medmamba.graph.call", "medmamba.graph.guard",
            "medmamba.graph.copy_in", "medmamba.graph.launch"} <= names
    counters = {k: after["counters"].get(k, 0) - before["counters"].get(k, 0)
                for k in ("graph.captures", "graph.replays")}
    assert counters == {"graph.captures": 1, "graph.replays": 3}
    assert after["counters"]["graph.nodes.train step"] > 100
    step.free()


def test_tracing_markers_of_a_replayed_forward_in_order(cuda):
    """Two replays of the graphed forward: ``forward.begin``,
    ``forward.model``, ``forward.end`` each, after its ``graph.launch``
    span; an eager CUDA ``eval_step`` launches its two markers too."""
    from medmamba_tpu_torch.train import trainer

    model = _graph_model(cuda)
    forward = trainer.compile_forward(model)
    x = _frames(cuda, 3)
    forward(x, image_size=64)
    marks, k2, spans, launches = _traced_replays(forward, x, image_size=64)
    assert [m for m, _, _ in marks] == ["forward.begin", "forward.model",
                                        "forward.end"] * 2
    assert not k2
    assert launches[0] < marks[0][1] and launches[1] < marks[3][1]
    forward.free()
    marks, _, _, _ = _traced_replays(
        lambda: trainer.eval_step(model, x, torch.tensor([0, 1, 2],
                                                         device=cuda),
                                  image_size=64))
    assert [m for m, _, _ in marks] == ["eval.begin", "eval.end"] * 2
