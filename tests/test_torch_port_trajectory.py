"""The port's training trajectory against the JAX package's in one process,
on the CPU: arm (a) of the trajectory harness (``torch_port_trajectory.py``)
in its quick tier, and the port's copy of the JAX tool's data stream.

The tiny VSSM (depths (1, 1), dims (8, 16), d_state 4) at 16^2, batch 8,
augmentation off, drop path 0, trains for STEPS steps of one uint8 grating
stream in the port (plain scan), in JAX (``train_step``, ``scan_impl=
"seq"``) from the same ``init_state`` weights, and in the port from
another init seed (the yardstick). The gates, fixed before the first full
run: each of the first 5 losses within 1e-5 relative of JAX's; the
final-quarter smoothed |Δloss|, the parameters' relative L2 gap and the
BatchNorm running statistics' relative L2 gap against JAX each at most
0.1x the seed-noise arm's.
"""
import numpy as np
import pytest

import torch_port_trajectory as harness
from medmamba_tpu_torch.tools import trajectory
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

STEPS = 100


@pytest.fixture(scope="module")
def arms(_settle_torch_exp):
    setup = harness.Setup(harness.TINY, harness.SIZE, STEPS)
    return trajectory.compare(setup.port(), setup.jax(), setup.noise())


def test_first_losses_match_jax(arms):
    assert arms["first5_loss_rel"] <= harness.FIRST_REL, arms


@pytest.mark.parametrize("gap", ["loss_gap", "param_gap", "stats_gap"])
def test_one_process_stays_far_under_seed_noise(arms, gap):
    assert arms[gap] <= harness.RATIO * arms[f"noise_{gap}"], arms


@pytest.mark.parametrize("side,classes,seed", [(16, 3, 11), (32, 9, 12)])
def test_grating_data_is_the_jax_tools_stream_quantised(side, classes, seed):
    """The port's copy gives the JAX tool's draws (``tools/
    trajectory_parity.py: make_grating_data``), quantised: x in [-2, 2]
    onto [0, 255]."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "trajectory_parity.py")
    spec = importlib.util.spec_from_file_location("trajectory_parity", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    x, labels = tool.make_grating_data(40, side, classes, seed)
    images, got_labels = trajectory.make_grating_data(40, side, classes,
                                                      seed)
    want = np.clip(np.rint((x.astype(np.float64) + 2.0) * 63.75), 0, 255)
    assert images.dtype == np.uint8 and images.shape == (40, side, side, 3)
    np.testing.assert_array_equal(got_labels, labels)
    # the tool returns float32 values: a pixel within rounding of a .5
    # boundary may land on either side
    assert np.abs(images.astype(np.int64) - want).max() <= 1
    assert (images == want).mean() > 0.999


def test_smoothing_and_gaps_follow_the_jax_tool():
    a = np.linspace(2.0, 1.0, 100)
    b = a + 0.25
    assert trajectory.smooth_window(100) == 10
    assert trajectory.smooth_window(500) == 20
    np.testing.assert_allclose(trajectory.final_quarter_gap(a, b), 0.25)
    s = trajectory.smooth(np.arange(12.0), 10)
    np.testing.assert_allclose(s, [4.5, 5.5, 6.5])


def test_gap_recorder_gives_float64_weight_gradients_and_layer_gaps():
    """The card tool's C2 reading on the CPU: ``recorded_step``'s float64
    gᵀx of every unsharded Linear and Conv2d weight is the float32
    gradient the step hands AdamW to float32 rounding (a bias in front of
    a BatchNorm, zero in exact arithmetic, left out), the swapped batch
    (``swap_halves``) gives the same layer inputs after its rows are put
    back, and ``gemm_report`` reads both runs."""
    import torch

    model_kw = dict(harness.TINY, drop_path_rate=0.0)
    weights = harness.VSSM(**model_kw).state_dict()
    images, labels = (torch.from_numpy(a) for a in
                      trajectory.make_grating_data(8, 16, 3, 0))
    record = (model_kw, weights, images, labels)
    one = trajectory.recorded_step(*record, image_size=16, keep="all",
                                   device="cpu")
    order = trajectory.swap_halves(8)
    swapped = trajectory.recorded_step(*record, image_size=16, keep="all",
                                       order=order, device="cpu")
    held = [k for k in one["grads64"]
            if not harness.BIAS_BEFORE_BN.search(k)]
    assert f"{trajectory.GAP_LAYER}.weight" in held and len(held) >= 20
    for k in held:
        g64 = one["grads64"][k]
        assert float((one["grads"][k] - g64).norm()) \
            <= 1e-5 * float(g64.norm()), k
    layers = trajectory.layer_gaps(one, swapped, order)
    assert [n for n, *_ in layers][0] == "patch_embed.proj"
    assert all(x_gap <= 1e-5 and g_gap <= 1e-4 for _, x_gap, g_gap in layers)
    report = trajectory.gemm_report(one, {"ranks": [swapped],
                                          "swapped": [swapped]})
    assert report["total_gap_swapped"] <= 1e-4
    assert f"{trajectory.GAP_LAYER}.weight" in report["params"]


def test_jittered_moves_each_float_one_unit_in_the_last_place():
    import torch

    weights = harness.VSSM(**harness.TINY).state_dict()
    moved = trajectory.jittered(weights)
    assert moved.keys() == weights.keys()
    for k, w in weights.items():
        if not w.is_floating_point():
            assert torch.equal(moved[k], w), k
            continue
        up = torch.nextafter(w, torch.full_like(w, float("inf")))
        down = torch.nextafter(w, torch.full_like(w, float("-inf")))
        assert bool(((moved[k] == up) | (moved[k] == down)).all()), k
    assert 0 < trajectory.param_gap(moved, weights)["total"] < 1e-6
