"""The port's tracing module (``medmamba_tpu_torch/utils/tracing.py``) on
the CPU: span totals, nesting, snapshots and resets; the profiler record a
span makes (a host ``cpu_op``, never a user annotation, and none without a
profiler); the compiled step's counters on stub graphs; the markers doing
nothing off the card and under ``torch.export``; the marker table against
``csrc/marker.cu``; the prefetch's spans and the CLIs' operator lines.
The markers on the card: ``tests/test_torch_port_cuda.py -k tracing``."""
import logging
import os
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medmamba_tpu_torch.data.loader import device_prefetch
from medmamba_tpu_torch.ops import cuda_build
from medmamba_tpu_torch.utils import graphs, tracing


@pytest.fixture(autouse=True)
def clean():
    """Each test starts from empty totals and leaves none behind."""
    saved = (dict(tracing._spans), dict(tracing._counters))
    tracing.reset()
    yield
    tracing.reset()
    tracing._spans.update(saved[0])
    tracing._counters.update(saved[1])


def test_spans_nest_and_add_to_their_own_totals():
    with tracing.span("outer") as outer:
        for _ in range(3):
            with tracing.span("inner") as inner:
                time.sleep(0.002)
    spans = tracing.snapshot()["spans"]
    assert spans["inner"]["count"] == 3 and spans["outer"]["count"] == 1
    assert spans["inner"]["s"] >= 0.006
    assert spans["outer"]["s"] == outer.seconds >= spans["inner"]["s"]
    assert inner.seconds >= 0.002


def test_counters_gauges_snapshot_and_reset():
    tracing.count("graph.replays")
    tracing.count("graph.replays", 4)
    tracing.gauge("graph.nodes.forward", 17)
    tracing.gauge("graph.nodes.forward", 19)
    with tracing.span("graph.call"):
        pass
    snap = tracing.snapshot()
    assert snap["counters"] == {"graph.replays": 5,
                                "graph.nodes.forward": 19}
    assert snap["launches"] == graphs.read_counts()
    tracing.count("graph.replays")
    assert snap["counters"]["graph.replays"] == 5      # a copy
    tracing.reset()
    after = tracing.snapshot()
    assert after["spans"] == {} and after["counters"] == {}
    assert after["launches"] == graphs.read_counts()


def test_launch_counters_keep_their_keys_and_semantics(monkeypatch):
    """The five launch counters stay the kernel wrappers' module
    attributes, read whole by ``snapshot`` and untouched by ``reset``."""
    for m, a in graphs.COUNTERS:
        monkeypatch.setattr(m, a, 3)
    assert tracing.snapshot()["launches"] == {
        "scan_cuda.LAUNCHES": 3, "scan_cuda.BWD_LAUNCHES": 3,
        "scan_hillis.HILLIS_LAUNCHES": 3,
        "scan_hillis.HILLIS_BWD_LAUNCHES": 3, "rotate.LAUNCHES": 3}
    tracing.reset()
    assert set(tracing.snapshot()["launches"].values()) == {3}


def test_spans_are_host_ops_under_the_profiler_not_annotations():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("graph.call"):
            with tracing.span("graph.launch"):
                torch.ones(4).sum()
        with tracing.span("prefetch.hand"):
            pass
    ours = [e for e in prof.events() if e.name.startswith("medmamba.")]
    assert sorted(e.name for e in ours) == [
        "medmamba.graph.call", "medmamba.graph.launch",
        "medmamba.prefetch.hand"]
    for e in ours:
        assert not e.is_user_annotation
        assert e.device_type == torch.autograd.DeviceType.CPU
    launch = next(e for e in ours if e.name == "medmamba.graph.launch")
    assert launch.cpu_parent.name == "medmamba.graph.call"
    # the totals count under the profiler as without it
    assert tracing.snapshot()["spans"]["graph.call"]["count"] == 1


def test_a_span_makes_no_profiler_call_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the profiler was called")
    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    with tracing.span("graph.launch"):
        pass
    assert tracing.snapshot()["spans"]["graph.launch"]["count"] == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="profiler was called"):
            with tracing.span("graph.launch"):
                pass


class _StubGraph:
    def __init__(self, key):
        self.key, self.freed = key, False

    def __call__(self, *inputs):
        return self.key

    def free(self):
        self.freed = True


def test_compiled_step_counts_captures_replays_and_evictions():
    """A second call at one signature adds a replay and no capture; a
    capture beyond ``maxsize`` counts an eviction; every call is one
    ``graph.call`` span."""
    made = []

    def capture(x, *, tag):
        made.append(_StubGraph((tuple(x.shape), tag)))
        return made[-1]
    step = graphs.CompiledStep("stub", capture, maxsize=2)
    a, b, c = torch.zeros(1), torch.zeros(2), torch.zeros(3)

    def counters():
        got = tracing.snapshot()["counters"]
        return tuple(got.get(f"graph.{k}", 0)
                     for k in ("captures", "replays", "evictions"))
    step(a, tag=0)
    assert counters() == (1, 1, 0)
    step(a, tag=0)
    assert counters() == (1, 2, 0)
    step(b, tag=0)
    step(c, tag=0)                       # frees a's graph
    assert counters() == (3, 4, 1) and made[0].freed
    step(a, tag=0)                       # captured again, frees b's
    assert counters() == (4, 5, 2)
    assert tracing.snapshot()["spans"]["graph.call"]["count"] == 5
    step.free()


def test_markers_do_nothing_off_the_card(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a marker was launched")
    monkeypatch.setattr(cuda_build, "load", refuse)
    for like in (torch.zeros(2), torch.zeros(2, device="meta"), None):
        tracing.mark("step.begin", like)
    with pytest.raises(KeyError):
        tracing.mark("step.nowhere", torch.zeros(2))


def test_markers_do_nothing_under_fake_tensors_and_export(monkeypatch):
    """A fake CUDA tensor (what ``torch.export`` traces a card's module
    with) launches nothing, and ``torch.export`` itself is a trace the
    markers stay out of."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*a, **kw):
        raise AssertionError("a marker was launched")
    monkeypatch.setattr(cuda_build, "load", refuse)
    with FakeTensorMode():
        like = torch.empty(2, device="cuda")
        assert like.device.type == "cuda"
        tracing.mark("forward.begin", like)
    seen = []

    class Marked(torch.nn.Module):
        def forward(self, x):
            seen.append(tracing._traced())
            tracing.mark("forward.begin", x)
            return x * 2

    program = torch.export.export(Marked(), (torch.ones(3),), strict=False)
    assert seen and all(seen)
    assert not tracing._traced()
    assert torch.equal(program.module()(torch.ones(3)), 2 * torch.ones(3))


def test_marker_table_matches_the_kernel_source():
    """``csrc/marker.cu`` defines one kernel a name of ``MARKERS``, in its
    order, named as ``kernel_name`` says."""
    with open(os.path.join(cuda_build.CSRC, tracing.SOURCE)) as f:
        src = f.read()
    table = src[src.index("#define MEDMAMBA_MARKERS"):]
    table = table[:table.index("\n\n")]
    pairs = re.findall(r"X\((\w+), (\w+)\)", table)
    assert [f"{g}.{p}" for g, p in pairs] == list(tracing.MARKERS)
    assert len(set(tracing.MARKERS)) == len(tracing.MARKERS)
    assert tracing.kernel_name("step.backward") == \
        "medmamba_mark_step_backward()"
    assert all(re.fullmatch(r"[a-z]+\.[a-z]+", m) for m in tracing.MARKERS)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_spans_each_put_and_hand(device):
    batches = [(np.full((2, 3), i), np.arange(2)) for i in range(5)]
    got = list(device_prefetch(
        iter(batches), lambda x, y: (torch.from_numpy(x),
                                     torch.from_numpy(y)),
        device=device))
    assert [int(x[0, 0]) for x, _ in got] == list(range(5))
    spans = tracing.snapshot()["spans"]
    assert spans["prefetch.put"]["count"] == 5
    assert spans["prefetch.hand"]["count"] == 5


def test_summary_line_of_two_snapshots():
    before = tracing.snapshot()
    with tracing.span("graph.call"):
        with tracing.span("graph.capture"):
            time.sleep(0.01)
    tracing.count("graph.captures")
    tracing.count("graph.replays")
    for _ in range(3):
        with tracing.span("graph.call"):
            pass
        tracing.count("graph.replays")
    line = tracing.summary(before, tracing.snapshot(), 4)
    assert line.startswith("graphs: 4 replays, 1 captures, 0 evictions, ")
    host = float(re.search(r"([0-9.]+) host ms a replay", line).group(1))
    assert host < 5          # the capture's 10 ms left out
    assert "prefetch" not in line
    with tracing.span("prefetch.put"):
        pass
    assert "prefetch" in tracing.summary(before, tracing.snapshot(), 4)
    assert tracing.summary(before, before, 0) == (
        "graphs: 0 replays, 0 captures, 0 evictions, - host ms a replay")


def test_train_and_evaluate_clis_log_the_operator_line(tmp_path, caplog,
                                                       capsys):
    """``cli.train`` logs one tracing line an epoch (on the CPU: no graph,
    the prefetch's host time); ``cli.evaluate`` writes one at its end to
    standard error."""
    from medmamba_tpu_torch.cli import evaluate as evaluate_cli
    from medmamba_tpu_torch.cli import train as train_cli

    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        np.save(tmp_path / f"{split}_images.npy",
                rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8))
        np.save(tmp_path / f"{split}_labels.npy",
                (np.arange(n) % 3).reshape(n, 1).astype(np.int64))
    with caplog.at_level(logging.INFO, logger="medmamba_tpu_torch.train"):
        out = train_cli.main(["--train_dir", str(tmp_path), "--val_dir",
                              str(tmp_path), "--batch_size", "2",
                              "--epochs", "1", "--image_size", "32",
                              "--device", "cpu", "--save_dir",
                              str(tmp_path / "run"), "--log_every", "0"])
    lines = [r.getMessage() for r in caplog.records
             if "graphs:" in r.getMessage()]
    assert len(lines) == 1
    assert re.fullmatch(r"Epoch 1 train graphs: 0 replays, 0 captures, 0 "
                        r"evictions, - host ms a replay; prefetch [0-9.]+ "
                        r"host ms a step", lines[0]), lines[0]
    capsys.readouterr()
    evaluate_cli.main(["--checkpoint_path", out["last_path"], "--data_dir",
                       str(tmp_path), "--split", "val", "--image_size", "32",
                       "--device", "cpu", "--batch_size", "2"])
    err = capsys.readouterr().err
    assert ("evaluate graphs: 0 replays, 0 captures, 0 evictions, - host "
            "ms a replay") in err
