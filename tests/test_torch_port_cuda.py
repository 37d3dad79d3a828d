"""The CUDA selective-scan kernel against its plain version, on the card.

Marked ``cuda``: each test skips where torch sees no GPU. On a machine with
one: ``python -m pytest tests/test_torch_port_cuda.py -q``. Tolerances:
float32 output 1e-4 (the two differ only in the order of float32 operations
and fused multiply-adds); bfloat16 output 1e-2 (its last rounding, 2^-8
relative).
"""
import pytest
import torch

from medmamba_tpu_torch.models import vssm as tv
from medmamba_tpu_torch.ops import scan_cuda
from medmamba_tpu_torch.ops.selective_scan import selective_scan
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
