"""The CUDA kernels against their plain versions, on the card.

K1 (selective-scan forward, with its tile-entry states), K2 (its backward),
K3 and K4 (the doubling scan of ``MEDMAMBA_SCAN_KERNEL=hillis`` and its
backward), K5 (flip + rotation), the probes P1 and P2, and the launch
counts of a Grad-CAM. Marked ``cuda``: each test skips where
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
from medmamba_tpu_torch.ops import rotate, scan_cuda, scan_hillis
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
# shared u
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


# K3 and K4, the doubling scan of MEDMAMBA_SCAN_KERNEL=hillis: L 150 ends in a
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
