"""The port's training trajectory against the JAX package's in two gloo
data ranks, on the CPU: arm (b) of the trajectory harness
(``torch_port_trajectory.py``) in its quick tier, and C2's first-step
gradient gap of two ranks.

The port's two ranks step on halves of each global batch against JAX's
step on a 2-device data mesh (``replicate_state``, ``shard_batch``); the
tiny VSSM at 16^2, batch 8, augmentation off, drop path 0, STEPS steps of
one uint8 grating stream from the same ``init_state`` weights; the
yardstick is the port in one process from another init seed. The gates,
fixed before the first full run, are ``test_torch_port_trajectory.py``'s.

C2: the first step's gradient gap of the two ranks against one process,
relative L2 over every gradient, is within GAP_FACTOR (3, stated before
the first run) of the same gap in JAX (its 2-device data mesh against one
device): the gap is the order of float32 sums, as JAX's own is. The
model mesh's arm is ``test_torch_port_trajectory_tp.py``.
"""
import pytest

import torch_port_trajectory as harness
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

LAYOUT = "data"
STEPS = 40


@pytest.fixture(scope="module")
def run(_settle_torch_exp, tmp_path_factory):
    return harness.quick_mesh_run(LAYOUT, STEPS,
                                  tmp_path_factory.mktemp("ranks"))


def test_ranks_first_losses_match_jax(run):
    assert run["arms"]["first5_loss_rel"] <= harness.FIRST_REL, run["arms"]


@pytest.mark.parametrize("gap", ["loss_gap", "param_gap", "stats_gap"])
def test_ranks_stay_far_under_seed_noise(run, gap):
    arms = run["arms"]
    assert arms[gap] <= harness.RATIO * arms[f"noise_{gap}"], arms


def test_ranks_end_on_the_same_state(run):
    a, b = run["ranked"]
    assert (a["losses"] == b["losses"]).all()
    for k, v in a["state"].items():
        assert (b["state"][k] == v).all(), k


def test_two_rank_gradient_gap_is_within_jax_own(run):
    g = run["gaps"]
    assert g["port"]["total"] <= harness.GAP_FACTOR * g["jax"]["total"], (
        g["port"]["total"], g["jax"]["total"], g["port"]["order"][:5],
        g["jax"]["order"][:5])
