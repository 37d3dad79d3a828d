"""The readers of the program's markers and spans (``core/phases.py`` and
the metrics that use it) on hand-built traces with known answers, on the
CPU."""
import pytest

from port_bench.core import harness, phases, trace


def _mark(name, t):
    return (f"medmamba_mark_{name.replace('.', '_')}()", t, t + 0.1)


def _train_step(t):
    """One replayed step from ``t``: markers, kernels and the host span of
    its call. Inside it the card idles 1 (forward), 1 (backward) and 2
    (optimizer)."""
    device = [_mark("step.begin", t + 10), ("k_pre", t + 10.1, t + 12),
              _mark("step.forward", t + 12), ("gemm", t + 12.1, t + 25),
              ("conv", t + 26, t + 30),
              _mark("step.backward", t + 30),
              ("elementwise_kernel", t + 30.1, t + 40),
              ("scan_bwd_kernel", t + 41, t + 60),
              _mark("step.optimizer", t + 60),
              ("multi_tensor_apply", t + 60.1, t + 68),
              _mark("step.end", t + 70)]
    host = [("medmamba.graph.call", t + 8, t + 9.5),
            ("medmamba.graph.launch", t + 9, t + 9.4)]
    return device, host


@pytest.fixture
def train_ctx():
    d1, h1 = _train_step(0)
    d2, h2 = _train_step(100)
    copy = [("Memcpy HtoD (Pinned -> Device)", 75.0, 80.0)]
    tr = trace.Trace(d1 + d2 + copy, h1 + h2 + [("cudaGraphLaunch", 9, 9.3)],
                     (0.0, 200.0), steps=2)
    return dict(trace=tr, traffic={"mode": "train"})


def _read(name, ctx):
    return harness.reader(name)(ctx)


def test_the_idle_time_splits_into_gaps_inside_and_between_replays(
        train_ctx):
    tr = train_ctx["trace"]
    assert phases.brackets(tr) == [(10.0, 70.1), (110.0, 170.1)]
    inside = _read("graph_gap_ms.train", train_ctx)
    between = _read("launch_gap_ms.train", train_ctx)
    assert inside == pytest.approx(4.0 * 1e3)
    # [0, 10], [70.1, 110] less the copy's 5, [170.1, 200], over 2 steps
    assert between == pytest.approx((10 + 34.9 + 29.9) / 2 * 1e3)
    idle = tr.window_s - tr.busy_s()
    assert (inside + between) / 1e3 * tr.steps == pytest.approx(idle)


def test_phase_readers_take_busy_time_between_markers(train_ctx):
    assert _read("forward_ms.train", train_ctx) == pytest.approx(17e3)
    assert _read("backward_ms.train", train_ctx) == pytest.approx(29e3)
    assert _read("optimizer_ms.train", train_ctx) == pytest.approx(8e3)
    assert _read("backward_elementwise_ms.train", train_ctx) == \
        pytest.approx(9.9e3)
    # preprocessing, forward, backward and optimizer hold all the busy
    # time of the replays
    tr = train_ctx["trace"]
    pre = phases.phase_ms(tr, "step.begin")
    total = pre + sum(_read(f"{p}_ms.train", train_ctx)
                      for p in ("forward", "backward", "optimizer"))
    end_markers = 2 * 0.1
    assert total / 1e3 * tr.steps + end_markers == pytest.approx(
        phases.busy_s(tr, phases.brackets(tr)))


def test_replay_host_time_reads_the_call_spans(train_ctx):
    assert _read("replay_host_ms.train", train_ctx) == pytest.approx(1.5e3)


def test_eval_forward_phases():
    device, host = [], []
    for t in (0.0, 10.0):
        device += [_mark("forward.begin", t + 1), ("k_pre", t + 1.1, t + 2),
                   _mark("forward.model", t + 2), ("gemm", t + 2.1, t + 6),
                   ("gemm", t + 7, t + 8), _mark("forward.end", t + 8)]
        host.append(("medmamba.graph.call", t + 0.2, t + 0.7))
    tr = trace.Trace(device, host, (0.0, 20.0), steps=2)
    ctx = dict(trace=tr, traffic={"mode": "eval"})
    assert _read("forward_ms.eval", ctx) == pytest.approx(5e3)
    assert _read("graph_gap_ms.eval", ctx) == pytest.approx(1e3)
    assert _read("launch_gap_ms.eval", ctx) == pytest.approx(
        (1 + 2.9 + 1.9) / 2 * 1e3)
    assert _read("replay_host_ms.eval", ctx) == pytest.approx(0.5e3)


def test_a_program_without_marks_reads_nothing():
    """The parent's trace: kernels and host ops, no markers, no spans."""
    tr = trace.Trace([("gemm", 1.0, 2.0)], [("cudaGraphLaunch", 0.5, 0.9)],
                     (0.0, 3.0), steps=1)
    for mode, names in (("train", ("graph_gap_ms", "launch_gap_ms",
                                   "replay_host_ms", "forward_ms",
                                   "backward_ms", "optimizer_ms",
                                   "backward_elementwise_ms")),
                        ("eval", ("graph_gap_ms", "launch_gap_ms",
                                  "replay_host_ms", "forward_ms"))):
        ctx = dict(trace=tr, traffic={"mode": mode})
        for name in names:
            assert _read(f"{name}.{mode}", ctx) is None, name


def test_every_marker_falls_in_no_kernel_family():
    from medmamba_tpu_torch.utils import tracing
    for m in tracing.MARKERS:
        name = tracing.kernel_name(m)
        assert trace.family(name) == "other", m
        assert trace.family("void " + name) == "other", m
        got = phases.markers(trace.Trace([(name, 1.0, 1.1)], [], (0.0, 2.0),
                                         steps=1))
        assert [n for n, _, _ in got] == [m]


def test_program_counter_readers_read_the_programs_totals():
    from medmamba_tpu_torch.utils import tracing
    saved = (dict(tracing._spans), dict(tracing._counters))
    tracing.reset()
    try:
        ctx = {"traffic": {"mode": "train"}}
        assert _read("graph_nodes.train", ctx) is None
        assert _read("capture_s", ctx) is None
        tracing.gauge("graph.nodes.train step", 3456)
        tracing.gauge("graph.nodes.forward", 1234)
        with tracing.span("graph.capture") as timed:
            pass
        assert _read("graph_nodes.train", ctx) == 3456
        assert _read("graph_nodes.eval", {"traffic": {"mode": "eval"}}) \
            == 1234
        assert _read("capture_s", ctx) == timed.seconds
    finally:
        tracing.reset()
        tracing._spans.update(saved[0])
        tracing._counters.update(saved[1])
