"""The language-model cell's pieces on the CPU, at a tiny Jamba: the
comparison of ``core/check_lm.py`` between the program's eager token steps
and the reference's (``modes/extensions.py: lm_reference``) reads rounding
alone, its planted faults move it, and ``core/work_lm.py`` counts what
the model holds."""
import json
import os

import pytest
import torch

from port_bench.core import check_lm, harness, work_lm
from port_bench.modes import common, extensions
from port_bench.reference import jamba as ref

CFG = dict(json.load(open(os.path.join(harness.ROOT, "port_bench",
                                       "configs", "jamba2_3b.json"))),
           hidden_size=64, intermediate_size=128, mamba_dt_rank=8,
           vocab_size=256, num_attention_heads=4, attn_layer_period=4,
           attn_layer_offset=2, num_hidden_layers=4)
TR = dict(batch=2, seq_len=64, pool=3, lr=1e-4, weight_decay=1e-4,
          check_steps=2)
SEED = 2147483905


def program(fault=None):
    """The program's numbers as ``modes/lm_train.py`` keeps them, from its
    eager steps on the CPU."""
    from medmamba_tpu_torch.models.registry import create_lm
    from medmamba_tpu_torch.train.trainer import lm_train_step, make_optimizer
    seeds = common.sub_seeds(SEED)
    weights = ref.make_weights(CFG, seeds["weights"], "cpu")
    with extensions.planted(fault):
        model = create_lm("jamba2_3b", CFG, device="cpu", init=False)
        model.load_state_dict(weights)
        opt, _ = make_optimizer(model.parameters(), TR["lr"], npz_mode=False)
        ids = extensions.lm_batches(CFG, TR, SEED, "cpu")
        losses, grads = [], None
        for k in range(TR["check_steps"]):
            losses.append(float(lm_train_step(model, opt, ids[k])))
            if k == 0:
                grads = {n: check_lm.norm(opt.state[p]["exp_avg"]) / 0.1
                         if "exp_avg" in opt.state.get(p, {})
                         else torch.zeros((), dtype=torch.float64)
                         for n, p in model.named_parameters()}
    change = {n: check_lm.norm(p.detach() - weights[n])
              for n, p in model.named_parameters()}
    return dict(losses=losses, grads=grads, change=change)


@pytest.fixture(scope="module")
def reference():
    torch.exp(torch.zeros(1))
    return extensions.lm_reference(CFG, TR, SEED, "cpu")


def test_the_sound_program_reads_rounding(reference):
    got = check_lm.train_checks(program(), reference)
    assert set(got) == {"loss_gap", "grad_median_gap", "grad_ss2d_gap",
                        "grad_scan_gap", "change_gap"}
    assert max(got.values()) < 1e-3, got


@pytest.mark.parametrize("fault,number", [
    ("acausal_attention", "grad_ss2d_gap"), ("no_skip_d", "grad_scan_gap"),
    ("no_dbc_norms", "grad_ss2d_gap")])
def test_a_planted_fault_moves_its_number(reference, fault, number):
    got = check_lm.train_checks(program(fault), reference)
    assert got[number] > 0.05, got


def test_work_counts_the_models_parameters():
    cfg = dict(CFG, num_hidden_layers=14, hidden_size=2560,
               intermediate_size=8192, mamba_dt_rank=160,
               num_attention_heads=20, attn_layer_period=14,
               attn_layer_offset=7, vocab_size=65536)
    tokens = 8192
    flops = work_lm.step_flops(cfg, 1, tokens, train=False)
    # 2 FLOPs a parameter a token, less the embedding's lookup and the
    # norms, plus the scan and the attention's products
    dense = 2 * tokens * (ref.parameter_count(cfg))
    assert dense * 0.95 < flops < dense * 1.2
    launches = work_lm.scan_launches(cfg, 2, tokens, "bfloat16")
    assert len(launches) == 13
    # u, delta and y (2, 5120, 8192), B and C (2, 1, 16, 8192) in bf16,
    # A, D and the dt bias in float32; nothing kept between K1 and K2
    act, bc, params = 2 * 5120 * tokens * 2, 2 * 16 * tokens * 2, \
        (5120 * 16 + 2 * 5120) * 4
    assert launches[0]["fwd_bytes"] == 3 * act + 2 * bc + params
    assert launches[0]["bwd_bytes"] == (3 * act + 2 * bc + params) + (
        2 * act + 2 * bc + params)
