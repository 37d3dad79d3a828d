"""The port's training trajectory against the JAX package's on a 1x2 model
mesh, on the CPU: arm (c) of the trajectory harness
(``torch_port_trajectory.py``) in its quick tier, and C2's first-step
gradient gap of the mesh.

The port's TP step in two gloo ranks (one data row of two model ranks:
partitioned parameters, column-parallel Dense layers, each rank scanning
half the rows) against JAX's ``partition_params`` step on a (1, 2) mesh;
the tiny VSSM at 16^2, batch 8, augmentation off, drop path 0, STEPS
steps of one uint8 grating stream from the same ``init_state`` weights;
the yardstick is the port in one process from another init seed. The
gates, fixed before the first full run, are
``test_torch_port_trajectory.py``'s.

C2: the first step's gradient gap of the mesh against one process (the
shards gathered), relative L2 over every gradient, is within GAP_FACTOR
(3, stated before the first run) of the same gap in JAX (its (1, 2) mesh
against one device).
"""
import pytest

import torch_port_trajectory as harness
from test_torch_port_scan import _settle_torch_exp  # noqa: F401

LAYOUT = "model"
STEPS = 40


@pytest.fixture(scope="module")
def run(_settle_torch_exp, tmp_path_factory):
    return harness.quick_mesh_run(LAYOUT, STEPS,
                                  tmp_path_factory.mktemp("ranks"))


def test_model_mesh_first_losses_match_jax(run):
    assert run["arms"]["first5_loss_rel"] <= harness.FIRST_REL, run["arms"]


@pytest.mark.parametrize("gap", ["loss_gap", "param_gap", "stats_gap"])
def test_model_mesh_stays_far_under_seed_noise(run, gap):
    arms = run["arms"]
    assert arms[gap] <= harness.RATIO * arms[f"noise_{gap}"], arms


def test_model_ranks_end_on_the_same_state(run):
    a, b = run["ranked"]
    assert (a["losses"] == b["losses"]).all()
    for k, v in a["state"].items():
        assert (b["state"][k] == v).all(), k


def test_model_mesh_gradient_gap_is_within_jax_own(run):
    g = run["gaps"]
    assert g["port"]["total"] <= harness.GAP_FACTOR * g["jax"]["total"], (
        g["port"]["total"], g["jax"]["total"], g["port"]["order"][:5],
        g["jax"]["order"][:5])
