"""One run of one cell: resolve it from ``BENCHMARK.json``, run its traffic
mode on the card, read its metrics, print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the model's sizes (the ``file`` of the
  configuration's entry);
* ``traffic/<traffic>.json``: the mix's parameters, among them ``mode``,
  the loop in ``modes/<mode>.py`` that runs it;
* ``limits/<workload>.json``: the limit of each number that decides the
  cell's ``correct``;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` that returns a number, or None where it finds nothing to
  read. A metric split by traffic mode (``mfu.train``, ``mfu.eval``) may
  share one reader, ``metrics/mfu.py``, which reads the mode from
  ``ctx["traffic"]``.

A mode's ``run(cell)`` returns an :class:`Outcome`. With ``--trace 0`` the
line carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from the trace of the window.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "medmamba_tpu")


@dataclasses.dataclass
class Cell:
    """One cell as a run sees it."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    t0: float                   # the process's start, time.time()
    fault: Optional[str] = None  # a fault of core/faults.py to plant


@dataclasses.dataclass
class Outcome:
    """What a mode hands back. ``e2e``: end-to-end metrics by name;
    ``checks``: (name, value, limit) of each number compared;
    ``ctx``: what the per-layer readers read (the trace among it)."""
    e2e: Dict[str, float]
    checks: List[Tuple[str, float, float]]
    attempted: int
    failed: int
    device: dict
    ctx: dict


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: str = ROOT
            ) -> Tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic, limits) of a cell, from the
    files its names lead to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return (w, _json(root, entry["file"]),
            _json(root, "port_bench", "traffic", w["traffic"] + ".json"),
            _json(root, "port_bench", "limits", workload + ".json"))


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones (those that list it, or list no
    cells and move a metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def reader_path(name: str, root: str = ROOT) -> str:
    """``metrics/<name>.py``, or where there is none, the reader of the
    name without its last dotted part (``mfu.train``: ``mfu.py``)."""
    base = os.path.join(root, "port_bench", "metrics")
    path = os.path.join(base, name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(base, name.rsplit(".", 1)[0] + ".py")
    return path


def reader(name: str, root: str = ROOT) -> Callable[[dict], Optional[float]]:
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="One run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell: Cell) -> Outcome:
    mode = importlib.import_module(
        "port_bench.modes." + cell.traffic["mode"])
    return mode.run(cell)


def result_line(bench: dict, cell: Cell, out: Outcome) -> dict:
    metrics = {}
    for m in cell_metrics(bench, cell.name, cell.trace):
        value = (out.e2e.get(m["name"]) if not cell.trace
                 else reader(m["name"])(out.ctx))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(v <= lim for _, v, lim in out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": out.device}
    if cell.trace and "trace" in out.ctx:
        tr = out.ctx["trace"]
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.top_gaps()}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    return line


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = load_benchmark()
    w, config, traffic, limits = resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    count = torch.cuda.device_count()
    if count < w["chips"]:
        print(f"{w['name']} needs {w['chips']} cards, {count} present",
              file=sys.stderr)
        return 2
    cell = Cell(w["name"], config, traffic, limits, w["chips"], args.seed,
                args.seconds, bool(args.trace), t0)
    out = run_cell(cell)
    line = result_line(bench, cell, out)
    # after the readers too: whatever they load counts
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0
