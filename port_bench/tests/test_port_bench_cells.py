"""``BENCHMARK.json`` against the contract and against the files its names
lead to, on the CPU."""
import ast
import json
import os
import re
import shutil

import pytest

from port_bench.core import faults, harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_entries():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_names_and_units_use_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                         "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in metrics:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    w, config, traffic, limits = harness.resolve(BENCH, cell)
    assert config["name"] == w["config"]
    assert os.path.exists(os.path.join(ROOT, "port_bench", "modes",
                                       traffic["mode"] + ".py"))
    assert set(limits) <= {"loss_gap", "grad_median_gap", "grad_ss2d_gap",
                           "grad_scan_gap", "change_gap", "prob_gap"} and limits
    for m in harness.cell_metrics(BENCH, cell, trace=True):
        assert os.path.exists(harness.reader_path(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, trace=True)


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in harness.cell_metrics(BENCH, cell,
                                                           False)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_a_cell_dropped_into_a_copy_is_found_without_an_edit(tmp_path):
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench")
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "port_bench" / "traffic" / "train_b32_plain.json"
     ).write_text(json.dumps({"mode": "train", "batch": 32, "pool": 4,
                              "augment": False}))
    (tmp_path / "port_bench" / "limits" / "t_train_b32.json"
     ).write_text(json.dumps({"loss_gap": 0.01}))
    bench["workloads"].append({"name": "t_train_b32", "config": "medmamba_t",
                               "traffic": "train_b32_plain", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"][0]["workloads"].append("t_train_b32")
    bench["end_to_end"][0]["workloads"].append("t_train_b32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    got = harness.load_benchmark(str(tmp_path))
    w, config, traffic, limits = harness.resolve(got, "t_train_b32",
                                                 str(tmp_path))
    assert config["name"] == "medmamba_t" and traffic["batch"] == 32
    names = {m["name"] for m in harness.cell_metrics(got, "t_train_b32",
                                                     True)}
    assert bench["per_layer"][0]["name"] in names


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "port_bench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


@pytest.mark.parametrize("sub", ["reference", "core"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    for path in _sources(sub):
        if sub == "core" and os.path.basename(path) in ("faults.py",
                                                        "harness.py"):
            continue       # they patch or load the program, by design
        assert "medmamba_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "medmamba_tpu_torch_like", sys)
    assert "medmamba_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_faults(cell):
    traffic = harness.resolve(BENCH, cell)[2]
    assert set(faults.BY_MODE[traffic["mode"]]) <= set(faults.FAULTS)
