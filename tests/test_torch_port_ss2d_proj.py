"""SS2D's low-rank projections (``models/vssm.py: ss2d_projections``) on
the CPU: against the einsum formulation the port ran before, which stays
here as the oracle, at every dt rank of medmamba_t/s/b/te's stages; the
parameters and the checkpoint schema as they were; no gradient reaching a
padded slot; the GEMMs' layouts (every leading stride a multiple of 8,
no copy of the input's size) and the ``ss2d.proj_padded`` counter. The
card's kernels and the graphed step's count: ``tests/test_torch_port_cuda.py
-k proj``."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.utils import tracing

N = 16
RANKS = [3, 4, 6, 8, 12, 16, 24, 32]


def einsum_projections(u, wx, wdt, n):
    """The port's projections before they ran on the scan's layout: two
    einsums over (batch, pair, direction), B and C copied per pair."""
    b, _, l = u.shape
    d, r = wx.shape[-1], wdt.shape[-1]
    xs = u.reshape(b, 2, d, l)
    x_dbl = torch.einsum("bkdl,jkcd->bjkcl", xs,
                         wx.reshape(2, 2, r + 2 * n, d))
    dts, bs, cs = torch.split(x_dbl, [r, n, n], dim=3)
    dts = torch.einsum("bjkrl,jkdr->bjkdl", dts, wdt.reshape(2, 2, d, r))
    return [(dts[:, j].reshape(b, 2 * d, l), bs[:, j].contiguous(),
             cs[:, j].contiguous()) for j in range(2)]


def _operands(r, dtype, b=3, l=24, seed=0):
    g = torch.Generator().manual_seed(seed + r)
    d = 32 * r if r <= 8 else 64
    u = torch.randn(b, 2 * d, l, generator=g).to(dtype)
    wx = (torch.randn(4, r + 2 * N, d, generator=g) * d ** -0.5).to(dtype)
    wdt = (torch.randn(4, d, r, generator=g) * r ** -0.5).to(dtype)
    return u, wx, wdt


def _run(fn, operands, cot_seed=99):
    """Outputs, then the gradients of u, x_proj and dt_projs."""
    leaves = [t.clone().requires_grad_() for t in operands]
    outs = [t for pair in fn(*leaves, N) for t in pair]
    g = torch.Generator().manual_seed(cot_seed)
    torch.autograd.backward(
        outs, [torch.randn(t.shape, generator=g).to(t.dtype) for t in outs])
    return [t.detach() for t in outs] + [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", RANKS)
def test_projections_match_the_einsum_oracle(r, dtype):
    """Outputs and the gradients of u, x_proj_weight and dt_projs_weight:
    float32 within 1e-6 of the largest entry, bfloat16 within one rounding
    of bfloat16 (2^-8 of the largest entry)."""
    ops = _operands(r, dtype)
    got, want = _run(tv.ss2d_projections, ops), _run(einsum_projections, ops)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    names = ["delta0", "B0", "C0", "delta1", "B1", "C1", "du", "dx_proj",
             "ddt_projs"]
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype, name
        assert a.is_contiguous() or name.startswith("d"), name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


def test_padded_slots_never_reach_a_gradient():
    """Weights padded to r8 = 8 by the caller, as leaves: the padded slots'
    gradients are exactly zero, the outputs and the real slots' gradients
    those of the unpadded weights, bit for bit."""
    r, r8 = 3, 8
    u, wx, wdt = _operands(r, torch.float32)
    wx8 = torch.cat([wx[:, :r], torch.zeros(4, r8 - r, wx.shape[-1]),
                     wx[:, r:]], 1)
    wdt8 = torch.cat([wdt, torch.zeros(*wdt.shape[:2], r8 - r)], 2)
    got = _run(tv.ss2d_projections, (u, wx8, wdt8))
    want = _run(tv.ss2d_projections, (u, wx, wdt))
    for a, b in zip(got[:7], want[:7]):
        assert torch.equal(a, b)
    assert torch.count_nonzero(got[7][:, r:r8]) == 0
    assert torch.count_nonzero(got[8][..., r:]) == 0
    assert torch.equal(torch.cat([got[7][:, :r], got[7][:, r8:]], 1),
                       want[7])
    assert torch.equal(got[8][..., :r], want[8])


@pytest.mark.parametrize("d_model", [48, 64, 96, 128])
def test_parameters_and_state_dict_keep_their_shapes(d_model):
    """The dt rank stays ceil(d_model / 16) in the parameters, padded or
    not; the state dict's keys and shapes are the reference's."""
    m = tv.SS2D(d_model, generator=torch.Generator().manual_seed(0))
    r, d = -(-d_model // 16), 2 * d_model
    assert m.dt_rank == r
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes == {
        "x_proj_weight": (4, r + 2 * N, d), "dt_projs_weight": (4, d, r),
        "dt_projs_bias": (4, d), "A_logs": (4 * d, N), "Ds": (4 * d,),
        "in_proj.weight": (2 * d, d_model), "conv2d.weight": (d, 1, 3, 3),
        "conv2d.bias": (d,), "out_norm.weight": (d,),
        "out_norm.bias": (d,), "out_proj.weight": (d_model, d)}


class _Ops(TorchDispatchMode):
    """Every operator dispatched, with its tensor arguments and results."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = list(args) + list((kwargs or {}).values())
        res = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append((func.overloadpacket.__name__,
                         [t for t in flat if torch.is_tensor(t)],
                         [t for t in res if torch.is_tensor(t)]))
        return out


def _leading_strides_aligned(t: torch.Tensor) -> bool:
    """Every stride but the unit one (and a broadcast batch's 0) is a
    multiple of 8 elements."""
    return all(s % 8 == 0 for s, n in zip(t.stride(), t.shape)
               if s != 1 and n > 1)


def test_gemm_layouts_at_the_t_stage0_width():
    """SS2D forward and backward at medmamba_t's stage-0 width (d_model
    48, dt rank 3, padded to 8), L = 64: every mm, bmm and addmm has
    operands and a result whose leading strides are multiples of 8; the
    projections copy nothing as large as the (B, 2, D, L) input, forward
    or backward; their GEMMs are one x_proj bmm and one dt bmm a pair, and
    their gradients'."""
    m = tv.SS2D(48, scan_impl="ref",
                generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 8, 48, requires_grad=True)
    with _Ops() as every:
        m(x).square().sum().backward()
    gemms = [(name, ts) for name, args, res in every.ops
             if name in ("mm", "bmm", "addmm") for ts in [args + res]]
    assert gemms
    for name, ts in gemms:
        assert all(_leading_strides_aligned(t) for t in ts), (
            name, [(tuple(t.shape), t.stride()) for t in ts])

    u = torch.randn(4, 2 * 96, 64, requires_grad=True)
    wx = m.x_proj_weight.detach().clone().requires_grad_()
    wdt = m.dt_projs_weight.detach().clone().requires_grad_()
    with _Ops() as fwd:
        outs = [t for pair in tv.ss2d_projections(u, wx, wdt, N)
                for t in pair]
    cot = [torch.ones_like(t) for t in outs]
    with _Ops() as bwd:
        torch.autograd.grad(outs, [u, wx, wdt], cot)
    full = u.numel()
    for ops in (fwd.ops, bwd.ops):
        copies = [(name, tuple(t.shape)) for name, args, res in ops
                  if name in ("clone", "copy_", "_to_copy", "cat", "stack",
                              "contiguous")
                  for t in args + res if t.numel() >= full]
        assert copies == [], copies
    assert [n for n, _, _ in fwd.ops].count("bmm") == 3
    assert [n for n, _, _ in bwd.ops].count("bmm") == 6


def test_counter_counts_padded_forwards():
    """``ss2d.proj_padded`` adds one a forward whose dt rank is not a
    multiple of 8, and none where it is."""
    before = tracing.step_counts()["ss2d.proj_padded"]
    for d_model, padded in ((48, 1), (64, 1), (128, 0), (256, 0)):
        m = tv.SS2D(d_model, scan_impl="ref",
                    generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            m(torch.randn(1, 2, 2, d_model))
        now = tracing.step_counts()["ss2d.proj_padded"]
        assert now - before == padded, d_model
        before = now
    snap = tracing.snapshot()
    tracing.count("ss2d.proj_padded", 16)
    assert tracing.summary(snap, tracing.snapshot(), 2).endswith(
        "- host ms a replay; ss2d.proj_padded 8 a step")
