"""The port's Jamba (``models/jamba.py``, built by ``models/registry.py:
create_lm``, trained by ``train/trainer.py: lm_train_step``) against the
benchmark's plain float32 reference (``port_bench/reference/jamba.py``) on
the CPU, at a small size with the published structure: hidden 64, d_inner
128, d_state 16, dt_rank 8, vocabulary 256, 64 tokens, 4 layers with
attention at index 2, 4 query heads of 16 over 1 key/value head.

Both sides compute in float32 on the same weights; they differ in the order
of float32 operations only: the port's scan is the sequential loop of
``ops/selective_scan.py`` and the reference's a two-level recurrence, the
port's attention is ``scaled_dot_product_attention`` and the reference's
an explicit masked softmax. Hence the tolerances: logits and loss 1e-5
relative (a few float32 roundings at the logits' scale), each gradient
1e-4 of its own largest entry (its sums over 2 x 64 positions and the
scan's reordered sums), each parameter after one AdamW step 1e-6 absolute
(the update is lr times a ratio of moments, about 1e-4, which rounding
moves by far less than 1e-6 except where a gradient entry is near zero:
there Adam's sign can flip, so such entries, under 1e-3 of the gradient's
largest, are left out).

The published configuration itself is checked on the meta device: the
layer order and the parameter count of 14 and 28 layers.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from medmamba_tpu_torch.models import registry  # noqa: E402
from medmamba_tpu_torch.models.jamba import Jamba  # noqa: E402
from medmamba_tpu_torch.train import trainer  # noqa: E402
from medmamba_tpu_torch.utils import tracing  # noqa: E402
from port_bench.reference import jamba as ref  # noqa: E402

SMALL = dict(hidden_size=64, intermediate_size=128, mamba_dt_rank=8,
             vocab_size=256, num_attention_heads=4, attn_layer_period=4,
             attn_layer_offset=2, num_hidden_layers=4)
LR, DECAY = 1e-4, 1e-4


@pytest.fixture(scope="module")
def small():
    torch.exp(torch.zeros(1))          # the first exp of a process
    cfg = registry.lm_config("jamba2_3b", SMALL)
    weights = ref.make_weights(cfg, 1234, "cpu")
    model = registry.create_lm("jamba2_3b", SMALL, device="cpu", init=False)
    model.load_state_dict(weights, strict=True)
    ids = torch.randint(0, 256, (2, 64),
                        generator=torch.Generator().manual_seed(7))
    return cfg, weights, model, ids


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_small_model_has_the_published_structure(small):
    cfg, weights, model, _ = small
    assert cfg["mamba_expand"] * cfg["hidden_size"] == 128
    assert [hasattr(layer, "self_attn") for layer in model.layers] == [
        False, False, True, False]
    assert model.layers[2].self_attn.k_proj.weight.shape == (16, 64)
    assert set(weights) == {n for n, _ in model.named_parameters()}


def test_logits_loss_and_gradients_match_the_reference(small):
    cfg, weights, model, ids = small
    model.zero_grad(set_to_none=True)
    logits = model(ids)
    with torch.no_grad():
        want = ref.forward(weights, ids, cfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 256)
    assert _rel(logits.detach(), want) < 1e-5
    loss = trainer.cross_entropy(
        logits.reshape(-1, 256),
        trainer.next_token_labels(ids).reshape(-1))
    loss.backward()
    P = {n: t.clone().requires_grad_(True) for n, t in weights.items()}
    want_loss, want_grads = ref.loss_and_grads(P, ids, cfg)
    assert abs(float(loss.detach()) - want_loss) / want_loss < 1e-5
    for name, p in model.named_parameters():
        assert _rel(p.grad, want_grads[name]) < 1e-4, name


def test_one_adamw_step_matches_the_reference(small):
    cfg, weights, model, ids = small
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), LR, npz_mode=False)
    assert opt.param_groups[0]["weight_decay"] == DECAY
    before = tracing.snapshot()["counters"].get("lm.tokens", 0)
    loss = trainer.lm_train_step(model, opt, ids)
    assert tracing.snapshot()["counters"]["lm.tokens"] - before == ids.numel()
    losses, grads, after = ref.train_steps(weights, [ids], cfg, lr=LR,
                                           weight_decay=DECAY)
    assert abs(float(loss) - losses[0]) / losses[0] < 1e-5
    for name, p in model.named_parameters():
        g = grads[name]
        clear = g.abs() >= 1e-3 * g.abs().max()
        gap = (p.detach() - after[name]).abs()[clear]
        assert float(gap.max()) < 1e-6, name


def lm_rank_step(rank, world, weights, ids):
    """One token step of the small model on this rank's rows of ``ids``
    under the active data mesh (``torch_port_ranks.spawn``)."""
    model = registry.create_lm("jamba2_3b", SMALL, device="cpu", init=False)
    model.load_state_dict(weights)
    opt, _ = trainer.make_optimizer(model.parameters(), LR, npz_mode=False)
    rows = ids.shape[0] // world
    loss = trainer.lm_train_step(model, opt, ids[rank * rows:
                                                 (rank + 1) * rows])
    return {"loss": loss, "grads": {n: p.grad.clone() for n, p in
                                    model.named_parameters()}}


def test_two_data_ranks_step_as_one_process(small, tmp_path):
    """Under two gloo data ranks, one sequence each, the token step's loss
    and gradients (summed by ``sum_grads``) are one process's on both: to
    1e-6 of the loss and 1e-5 of each gradient's largest entry (the sums
    over the two ranks' tokens are added in another order)."""
    import torch_port_ranks as ranks
    _, weights, _, ids = small
    want = lm_rank_step(0, 1, weights, ids)
    for got in ranks.spawn(lm_rank_step, 2, tmp_path, weights, ids):
        assert abs(float(got["loss"]) - float(want["loss"])) \
            <= 1e-6 * float(want["loss"])
        for name, w in want["grads"].items():
            assert _rel(got["grads"][name], w) < 1e-5, name


def test_next_token_labels_shift_and_mask_the_last_position():
    ids = torch.tensor([[5, 6, 7], [1, 2, 3]])
    assert trainer.next_token_labels(ids).tolist() == [[6, 7, -1],
                                                       [2, 3, -1]]


@pytest.mark.parametrize("layers,count,attention", [
    (14, 1_598_556_096, [7]), (28, 3_029_337_472, [7, 21])])
def test_published_config_layer_order_and_parameters(layers, count,
                                                     attention):
    cfg = registry.lm_config("jamba2_3b", num_hidden_layers=layers)
    with torch.device("meta"):
        model = Jamba(cfg)
    assert sum(p.numel() for p in model.parameters()) == count
    assert ref.parameter_count(cfg) == count
    assert [i for i, layer in enumerate(model.layers)
            if hasattr(layer, "self_attn")] == attention
    mixer = model.layers[0].mamba
    assert mixer.in_proj.weight.shape == (10240, 2560)
    assert mixer.x_proj.weight.shape == (192, 5120)
    assert mixer.conv1d.bias is not None and mixer.in_proj.bias is None
    attn = model.layers[7].self_attn
    assert attn.k_proj.weight.shape == (128, 2560)
    assert model.layers[7].feed_forward.up_proj.weight.shape == (8192, 2560)


def test_published_initialisation():
    gen = torch.Generator().manual_seed(3)
    model = registry.create_lm("jamba2_3b", SMALL, device="cpu",
                               generator=gen)
    mixer = model.layers[0].mamba
    assert torch.equal(mixer.A_log[5], torch.log(torch.arange(1.0, 17.0)))
    assert torch.equal(mixer.D, torch.ones(128))
    dt = torch.nn.functional.softplus(mixer.dt_proj.bias)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    w = model.layers[0].feed_forward.up_proj.weight
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert torch.equal(model.final_layernorm.weight, torch.ones(64))


def test_train_cli_trains_the_language_model_one_step(tmp_path):
    from medmamba_tpu_torch.cli import train
    ids = np.random.default_rng(0).integers(0, 256, (2, 64))
    np.save(tmp_path / "ids.npy", ids)
    (tmp_path / "cfg.json").write_text(json.dumps(SMALL))
    out = train.main(["--model", "jamba2_3b", "--token_npy",
                      str(tmp_path / "ids.npy"), "--lm_config",
                      str(tmp_path / "cfg.json"), "--batch_size", "2",
                      "--device", "cpu", "--save_dir", str(tmp_path / "run"),
                      "--log_every", "0"])
    assert len(out["step_losses"]) == 1
    assert abs(out["step_losses"][0] - np.log(256)) < 0.1
    saved = torch.load(out["last_path"])
    assert saved["config"]["num_hidden_layers"] == 4
    assert "layers.2.self_attn.q_proj.weight" in saved["model_state_dict"]


def test_train_cli_asks_for_the_token_file():
    from medmamba_tpu_torch.cli import train
    with pytest.raises(SystemExit):
        train.parse_args(["--model", "jamba2_3b"])
    with pytest.raises(SystemExit):
        train.parse_args(["--train_dir", "d"])
