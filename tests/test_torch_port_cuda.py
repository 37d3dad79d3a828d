"""The CUDA kernels against their plain versions, on the card.

K1 (selective-scan forward, with its tile-entry states), K2 (its backward),
K3 and K4 (the scan of ``MEDMAMBA_SCAN_KERNEL=hillis`` and its backward,
held against the JAX package's doubling written in plain PyTorch), K5 (flip
+ rotation), the probes P1 and P2, the launch counts of a Grad-CAM, and the
graph ops of ``ops/scan_op.py`` and an exported artifact on the card.
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
