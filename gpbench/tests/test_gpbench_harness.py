"""The harness finds everything by name, runs a cell end to end on the CPU
at a small size, and prints what the contract asks for."""

import json
import os
import shutil

import pytest

from gpbench import harness

from .conftest import ROOT, SMALL, TRAFFIC


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_has_its_files():
    b = bench()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("gpbench/configs/")
    for w in b["workloads"]:
        cell = harness.Cell(w["name"], 1)
        gaps = set(cell.limits)
        assert gaps, w["name"]
        assert cell.entry.__name__.endswith(cell.traffic["entry"])
        assert w["chips"] == 1
    for kind, folder in (("end_to_end", "end_to_end"),
                         ("per_layer", "layer_metrics")):
        for m in b[kind]:
            assert os.path.exists(os.path.join(
                ROOT, "gpbench", folder, m["name"].split(".")[0] + ".py")), \
                m["name"]


def test_metrics_of_each_cell():
    e2e = {w: [m["name"] for m in harness.Cell(w, 1).metrics("end_to_end")]
           for w in ("hodlr_smooth_1e5.fit", "sparse_dia_2e5.fit")}
    assert e2e["hodlr_smooth_1e5.fit"] == ["call_ms", "call_p95_ms",
                                           "peak_mem_gb", "setup_s"]
    assert e2e["sparse_dia_2e5.fit"] == ["call_ms.sparse", "peak_mem_gb",
                                         "setup_s"]
    layer = [m["name"] for m in harness.Cell(
        "sparse_dia_2e5.fit", 1).metrics("per_layer")]
    assert layer == ["compute_s", "device_idle_pct.sparse",
                     "device_ops_per_call.sparse", "dia_roofline",
                     "dia_launches_per_call"]


@pytest.mark.parametrize("workload", ["hodlr_smooth_1e5.fit",
                                      "hodlr_smooth_1e5.chains8",
                                      "hodlr_smooth_1e5.predict",
                                      "sparse_dia_2e5.fit"])
@pytest.mark.parametrize("trace", [False, True])
def test_run_on_cpu(workload, trace):
    cfg = workload.split(".")[0]
    result, checks = harness.run_cell(workload, 2 ** 33 + 11, 0.5, trace,
                                      device="cpu", overrides=SMALL[cfg],
                                      traffic=TRAFFIC)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    cell = harness.Cell(workload, 1)
    kind = "per_layer" if trace else "end_to_end"
    names = [m["name"] for m in cell.metrics(kind)]
    # on the CPU the device's readers find nothing to read
    assert set(result["metrics"]) <= set(names)
    if not trace:
        assert set(result["metrics"]) == set(names) - {"peak_mem_gb"}
    else:
        assert "breakdown" in result and "busy_s" in result["device"]
    for m in cell.metrics(kind):
        if m["name"] in result["metrics"]:
            assert result["metrics"][m["name"]]["unit"] == m["unit"]
    assert [c[0] for c in checks] == list(cell.limits)
    json.dumps(result)


def test_a_cell_added_as_files(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer metric
    added as new files and entries only are found and run."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "gpbench"), root / "gpbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    b = bench()
    cfg = json.loads((root / "gpbench/configs/hodlr_smooth_1e5.json")
                     .read_text())
    cfg["name"] = "hodlr_small"
    cfg["kernel"] = {"scale": [2.0, {"Matern32": {"metric": 4.0}}]}
    (root / "gpbench/configs/hodlr_small.json").write_text(json.dumps(cfg))
    (root / "gpbench/traffic/fit2.json").write_text(json.dumps(
        {"entry": "value_and_grad", "chains": 2, "theta_sd": 0.02,
         "max_calls_per_s": 40, "warmup_calls": 1, "check_calls": 1,
         "trace_calls": 1}))
    (root / "gpbench/limits/hodlr_small.fit2.json").write_text(json.dumps(
        {"value_gap": 1e-4, "grad_gap": 1e-2}))
    (root / "gpbench/layer_metrics/calls_traced.py").write_text(
        "def read(run):\n    return run.calls\n")
    b["configs"].append({"name": "hodlr_small", "source": "test",
                         "file": "gpbench/configs/hodlr_small.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "hodlr_small.fit2",
                           "config": "hodlr_small", "traffic": "fit2",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "call_ms",
                           "workloads": ["hodlr_small.fit2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    result, _ = harness.run_cell("hodlr_small.fit2", 3, 0.5, True,
                                 device="cpu", root=str(root),
                                 overrides=SMALL["hodlr_smooth_1e5"])
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["calls_traced"]["value"] == 1.0
