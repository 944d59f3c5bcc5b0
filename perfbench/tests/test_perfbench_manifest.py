"""BENCHMARK.json against the benchmark's files and its contract's
limits on names, units and sizes."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / MANIFEST["command"][1]).is_file()
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


@pytest.mark.parametrize("wl", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(wl):
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"])
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] == 1 and 1 <= len(wl["why"]) <= 200
    cell = harness.load_cell(ROOT, wl["name"])
    assert cell.traffic["check_rounds"] == cell.traffic["h"] + 1
    numbers = {"r1_loss", "r1_update", "r1_rates", "rh1_loss",
               "rh1_update", "rh1_clients", "rh1_local", "rh1_uploaded"}
    assert set(cell.limits) <= numbers
    assert {"r1_update", "r1_rates", "rh1_local"} <= set(cell.limits)
    assert all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_resolves(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and conf["file"].startswith("perfbench/")
    body = json.loads((ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"] and body["reduced"] == conf["reduced"]
    assert body["dtype"] == "float32" and body["specs"]
    assert any(w["config"] == conf["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_names_unique_and_setup_present():
    for group in (METRICS, MANIFEST["workloads"], MANIFEST["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("wl", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_its_layers_move(wl):
    def applies(m):
        return wl["name"] in m.get("workloads", [wl["name"]])
    e2e = {m["name"] for m in MANIFEST["end_to_end"] if applies(m)}
    layer = [m for m in MANIFEST["per_layer"] if applies(m)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_reader_without_trace_returns_nothing(metric):
    """A per-layer reader that finds nothing to read (no trace, no spans)
    returns None, never 0."""
    run = harness.RunData(cfg={"specs": [[["fc", 4, 2]]], "global_spec": 0},
                          traffic={"h": 5}, client_spec=[0, 0], setup_s=1.0,
                          round_s=[0.5, 0.5], window_s=1.0,
                          flops_per_round=10 ** 9,
                          peaks={"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12})
    assert harness.reader(metric["name"])(run) is None
