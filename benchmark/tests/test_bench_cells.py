"""BENCHMARK.json keeps the shape the check reads, and every configuration,
cell, traffic mix, driver and per-layer metric in it resolves by name to
its files."""

import json
import re

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert NAME.match(cfg["name"])
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    cell = harness.load_cell(w["name"])
    assert (harness.BENCH / "drivers" / f"{cell.driver}.py").exists()
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    drv = harness.driver_module(cell)
    assert callable(drv.run) and callable(drv.control)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        mod = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py")
        assert mod.read({}) is None     # nothing to read: left out, never 0
        names = {e["name"] for e in BENCH["end_to_end"]}
        assert m["moves"] in names
        for w in m["workloads"]:
            cell = harness.load_cell(w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


WITHDRAWN = json.loads((harness.BENCH / "withdrawn.json").read_text())


@pytest.mark.parametrize("w", WITHDRAWN["workloads"], ids=lambda w: w["name"])
def test_withdrawn_cell_resolves_but_does_not_run(w):
    """A cell taken out of BENCHMARK.json keeps its files and resolves for
    its tests, and benchmark.run refuses it."""
    assert all(b["name"] != w["name"] for b in BENCH["workloads"])
    with pytest.raises(KeyError):
        harness.load_cell(w["name"])
    cell = harness.load_cell(w["name"], withdrawn=True)
    assert (harness.BENCH / "drivers" / f"{cell.driver}.py").exists()
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("m", WITHDRAWN["end_to_end"] + WITHDRAWN["per_layer"],
                         ids=lambda m: m["name"])
def test_withdrawn_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(b["name"] != m["name"] for b in BENCH["end_to_end"] + BENCH["per_layer"])
    if m in WITHDRAWN["per_layer"]:
        mod = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py")
        assert mod.read({}) is None
