"""The plain reference against the program's eager path on the CPU, at a
tiny VSSM: the same weights, batches and draws give the same
probabilities, losses and updated parameters (float32 blocks, so both
sides compute alike and agree to rounding)."""
import pytest
import torch

from port_bench.core import check
from port_bench.modes import common
from port_bench.reference import vssm as ref

CFG = dict(depths=[2, 2], dims=[16, 32], d_state=16, patch_size=4,
           image_size=32, num_classes=9, drop_path_rate=0.1)


@pytest.fixture(scope="module")
def setup():
    from medmamba_tpu_torch.models.vssm import VSSM
    torch.exp(torch.zeros(1))          # the first exp of a process
    weights = ref.make_weights(CFG, 123, "cpu")
    model = VSSM(num_classes=9, depths=CFG["depths"], dims=CFG["dims"],
                 d_state=16, drop_path_rate=0.1)
    model.load_state_dict({**weights,
                           **ref.batch_norm_buffers(CFG, "cpu")},
                          strict=True)
    gen = torch.Generator().manual_seed(5)
    images = torch.randint(0, 256, (3, 8, 32, 32, 3), dtype=torch.uint8,
                           generator=gen)
    labels = torch.randint(0, 9, (3, 8), generator=gen)
    return model, weights, images, labels


def test_weights_are_the_seeds_and_fill_the_model(setup):
    model, weights, _, _ = setup
    again = ref.make_weights(CFG, 123, "cpu")
    assert all(torch.equal(weights[n], again[n]) for n in weights)
    other = ref.make_weights(CFG, 124, "cpu")
    assert not torch.equal(weights["head.weight"], other["head.weight"])
    a = weights["layers.0.blocks.0.self_attention.A_logs"]
    assert torch.allclose(a[0], torch.log(torch.arange(1.0, 17.0)))
    assert set(weights) == {n for n, _ in model.named_parameters()}


def test_probabilities_match_the_programs_eager_forward(setup):
    from medmamba_tpu_torch.train.trainer import predict
    model, weights, images, _ = setup
    got = predict(model, images[0], image_size=32)[0]
    want = ref.probabilities({**weights,
                              **ref.batch_norm_buffers(CFG, "cpu")},
                             images[0], CFG)
    assert check.prob_gap(got, want) < 1e-5


def test_three_steps_match_the_programs_eager_steps(setup):
    from medmamba_tpu_torch.train.trainer import make_optimizer, train_step
    model, weights, images, labels = setup
    opt, _ = make_optimizer(model.parameters(), 1e-4, npz_mode=False)
    gen = torch.Generator().manual_seed(77)
    losses = []
    for s in range(3):
        losses.append(float(train_step(model, opt, images[s], labels[s],
                                       generator=gen, augment=True,
                                       image_size=32)))
        if s == 0:
            grads = {n: opt.state[p]["exp_avg"] / 0.1
                     for n, p in model.named_parameters()}
    prog = dict(losses=losses, grads=grads,
                change={n: p.detach() - weights[n]
                        for n, p in model.named_parameters()})
    r_losses, r_grads, r_params = ref.train_steps(
        weights, [(images[s], labels[s]) for s in range(3)], CFG,
        gen=torch.Generator().manual_seed(77), lr=1e-4, weight_decay=1e-4)
    want = dict(losses=r_losses, grads=r_grads,
                change={n: r_params[n] - weights[n] for n in r_params})
    gaps = check.train_checks(prog, want, check.train_gaps(prog, want))
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_median_gap"] < 1e-5
    assert gaps["grad_ss2d_gap"] < 1e-5
    assert gaps["grad_scan_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-3
    # each counted leaf's change, element by element: Adam's first steps
    # move an element by about lr whatever its gradient, so an element of
    # tiny gradient can part by rounding; the leaf as a whole cannot
    worst = max(float((prog["change"][n] - want["change"][n]).norm()
                      / want["change"][n].norm())
                for n in check.counted_leaves(r_grads))
    assert worst < 1e-2


def test_the_leaves_left_out_are_those_round_off_moves():
    # the conv biases in front of a BatchNorm get no gradient
    grads = {"a": torch.ones(4), "b": torch.ones(4) * 2,
             "c": torch.ones(4) * 1e-9}
    assert check.counted_leaves(grads) == ["a", "b"]


def test_fp8_rounds_operands_forward_and_output_gradients_backward():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = ref.FP8(x)
    assert 0 < float((y - x).abs().max()) < 0.2
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(101))
    z = torch.ones(101, requires_grad=True)
    g = torch.linspace(0.01, 1, 101)
    ref.FP8.output(z).backward(g)
    assert torch.equal(ref.FP8.output(g), g)          # forward: identity
    err = (z.grad - g).abs() / g
    assert 0 < float(err.max()) <= 0.125               # 2 mantissa bits


def test_sub_seeds_differ_and_take_large_seeds():
    s = common.sub_seeds(2 ** 31 + 5)
    assert len(set(s.values())) == 3 and all(0 <= v < 2 ** 63
                                             for v in s.values())
    assert s == common.sub_seeds(2 ** 31 + 5) != common.sub_seeds(2 ** 31)


def _loop_scan(u, delta, A, B, C, D, bias):
    dt = torch.nn.functional.softplus(delta + bias[None, :, :, None])
    h = torch.zeros(u.shape[:3] + (A.shape[-1],), dtype=u.dtype)
    ys = []
    for t in range(u.shape[-1]):
        h = torch.exp(dt[..., t, None] * A) * h \
            + (dt[..., t] * u[..., t])[..., None] * B[:, :, None, :, t]
        ys.append((h * C[:, :, None, :, t]).sum(-1))
    return torch.stack(ys, -1) + D[None, :, :, None] * u


@pytest.mark.parametrize("length", [1, 7, 49, 50])
def test_the_two_level_scan_is_the_step_by_step_loop(length):
    gen = torch.Generator().manual_seed(length)
    b, k, di, n = 3, 4, 5, 16
    args = [torch.randn(b, k, di, length, generator=gen),
            torch.randn(b, k, di, length, generator=gen),
            -torch.rand(k, di, n, generator=gen) * 4,
            torch.randn(b, k, n, length, generator=gen),
            torch.randn(b, k, n, length, generator=gen),
            torch.randn(k, di, generator=gen),
            torch.randn(k, di, generator=gen)]
    args = [a.double().requires_grad_() for a in args]
    got = ref.scan_in_rows(*args, rows=2)
    want = _loop_scan(*args)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    gy = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    g_got = torch.autograd.grad(got, args, gy)
    g_want = torch.autograd.grad(want, args, gy)
    for a, w in zip(g_got, g_want):
        torch.testing.assert_close(a, w, rtol=1e-10, atol=1e-10)
