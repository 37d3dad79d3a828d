"""The benchmark's own arithmetic (``core/work.py``, ``core/trace.py``)
against hand counts and against the program's analytic count, on the
CPU."""
import json
import math
import os

import pytest

from port_bench.core import trace, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_medmamba_t_macs_per_image():
    # 2.576 GMAC an image forward, 5.151 GFLOP at 2 per MAC
    cfg = _config("medmamba_t")
    assert work.model_macs(cfg) == pytest.approx(2.5757e9, rel=1e-4)
    assert work.step_flops(cfg, 1, train=False) == pytest.approx(
        5.1514e9, rel=1e-4)
    assert work.step_flops(cfg, 64, train=True) == \
        3 * 64 * work.step_flops(cfg, 1, train=False)


@pytest.mark.parametrize("name", ["medmamba_t", "medmamba_b"])
def test_macs_match_the_programs_count(name):
    from medmamba_tpu_torch.utils.profiling import model_flops_report
    cfg = _config(name)
    want = model_flops_report(cfg["depths"], cfg["dims"], cfg["image_size"],
                              cfg["d_state"], cfg["num_classes"])
    assert work.model_macs(cfg) == want["total_macs"]


@pytest.mark.parametrize("name", ["medmamba_t", "medmamba_b"])
def test_parameter_count_matches_the_program(name):
    import torch
    from medmamba_tpu_torch.models.vssm import VSSM
    from port_bench.reference import vssm as ref
    cfg = _config(name)
    with torch.device("meta"):
        model = VSSM(num_classes=cfg["num_classes"], depths=cfg["depths"],
                     dims=cfg["dims"], d_state=cfg["d_state"])
    count = sum(p.numel() for p in model.parameters())
    assert count == cfg["parameters"]
    assert sum(math.prod(s) for _, s, _, _ in ref.leaves(cfg)) == count


def test_busy_union_counts_leading_and_trailing_idle():
    # window [0, 10]: kernels in [2, 4], [3, 5] (overlapping), [6, 7]
    device = [("k", 2.0, 4.0), ("k", 3.0, 5.0), ("Memcpy HtoD", 6.0, 7.0)]
    tr = trace.Trace(device, [("cudaGraphLaunch", 0.0, 1.5),
                              ("cudaStreamSynchronize", 7.5, 10.0)],
                     (0.0, 10.0), steps=2)
    assert tr.busy_s() == pytest.approx(4.0)
    assert tr.window_s == 10.0
    assert trace.idle_gaps([(2, 4), (3, 5), (6, 7)], 0, 10) == [
        (0, 2), (5, 6), (7, 10)]
    gaps = dict(tr.top_gaps())
    # each gap goes to the host operation at its middle
    assert gaps["cudaStreamSynchronize"] == pytest.approx(3.0)
    assert gaps["cudaGraphLaunch"] == pytest.approx(2.0)
    assert gaps["no host operation"] == pytest.approx(1.0)
    assert tr.family_s()["memcpy"] == pytest.approx(1.0)


def test_a_kernel_outside_the_window_is_cut_to_it():
    tr = trace.Trace([("k", -1.0, 1.0), ("k", 9.0, 12.0)], [], (0.0, 10.0),
                     steps=1)
    assert tr.busy_s() == pytest.approx(2.0)


def test_families_first_match_wins():
    assert trace.family("Memcpy HtoD (Pinned -> Device)") == "memcpy"
    assert trace.family("void scan_bwd_reduce_kernel<...>") == "scan_bwd"
    assert trace.family("scan_fwd_kernel<32, 4>") == "scan_fwd"
    assert trace.family("cudnn::conv_implicit_gemm") == "convolution"
    assert trace.family("sm90_xmma_gemm_bf16") == "matmul"
    assert trace.family(
        "void at::native::vectorized_elementwise_kernel<4>") == \
        "elementwise/copy"


def test_roofline_of_a_hand_counted_launch():
    # one medmamba_t stage-3 block at batch 2, bf16: L = 49, 2 Di = 1536
    cfg = _config("medmamba_t")
    last = work.scan_launches(cfg, 2, "bfloat16")[-1]
    act = 2 * 1536 * 49 * 2                  # u, delta, y (bf16)
    bc = 2 * 2 * 16 * 49 * 2                 # B, C
    params = (1536 * 16 + 2 * 1536) * 4      # A, D, dt bias (float32)
    assert last["fwd_bytes"] == 3 * act + 2 * bc + params
    assert last["bwd_bytes"] == (3 * act + 2 * bc + params) + (
        2 * act + 2 * bc + params)
    macs = 4 * 2 * 1536 * 49 * 16 + 2 * 1536 * 49
    assert last["fwd_flops"] == 2 * macs
    bound = work.bound_s(last["fwd_flops"], last["fwd_bytes"],
                         work.PEAK_FLOPS["float32"])
    assert bound == pytest.approx(max(2 * macs / 67e12,
                                      last["fwd_bytes"] / 3.35e12))
    # 20 launches a medmamba_t forward: 2 a block
    assert len(work.scan_launches(cfg, 64, "float32")) == 20


def test_scan_roofline_reader():
    from port_bench.core import harness
    cfg = _config("medmamba_t")
    launches = work.scan_launches(cfg, 64, "float32")
    bound = sum(work.bound_s(x["fwd_flops"], x["fwd_bytes"], 67e12)
                for x in launches)
    # two steps whose scan kernels take 4 bound each: 25%
    device = [("scan_fwd_kernel", 0.0, 4 * bound),
              ("scan_fwd_kernel", 5.0, 5.0 + 4 * bound)]
    tr = trace.Trace(device, [], (0.0, 10.0), steps=2)
    ctx = dict(config=cfg, trace=tr, batch=64, chips=1,
               block_dtype="float32")
    assert harness.reader("scan_fwd_roofline")(ctx) == pytest.approx(25.0)
    assert harness.reader("scan_bwd_roofline")(ctx) is None


def test_metrics_split_by_mode_share_one_reader():
    from port_bench.core import harness
    assert harness.reader_path("mfu.train").endswith("/metrics/mfu.py")
    assert harness.reader_path("h2d_copy_ms.eval").endswith(
        "/metrics/h2d_copy_ms.eval.py")
    cfg = _config("medmamba_t")
    tr = trace.Trace([("k", 0.0, 1.0)], [], (0.0, 1.0), steps=1)
    ctx = dict(config=cfg, trace=tr, batch=64, chips=1,
               block_dtype="bfloat16")
    mfu = harness.reader("mfu.train")
    train = mfu({**ctx, "traffic": {"mode": "train"}})
    evaluate = mfu({**ctx, "traffic": {"mode": "eval"}})
    # a step's forward and backward count as three forwards
    assert train == pytest.approx(3 * evaluate)
    assert evaluate == pytest.approx(
        100 * work.step_flops(cfg, 64, train=False) / 989e12)
