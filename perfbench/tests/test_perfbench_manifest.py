"""BENCHMARK.json against the contract it is written to, and every file
it names."""
import json
import math
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_a_full_check_fits_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for k in ("why", "layer", "source"):
        if k in entry and k != "source":
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
            assert "\t" not in entry[k]


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    wl = harness.workload(cell)
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"]
    assert wl["traffic"] == entry["traffic"] and wl["why"] == entry["why"]
    assert entry["chips"] in (1, 4)
    for path in (harness.BENCH / "configs" / f"{wl['config']}.json",
                 harness.BENCH / "traffic" / f"{wl['kind']}.py",
                 harness.BENCH / "cells" / f"{wl['loop']}.py"):
        assert path.is_file(), path


def test_config_entries():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, math.floor(0.25 * len(CELLS)))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in MAN["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics_name_their_cells(metric):
    assert metric["workloads"]
    assert all(cell in CELLS for cell in metric["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    assert (harness.BENCH / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in harness.metric_entries(MAN, cell, False)]
    layer = harness.metric_entries(MAN, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:          # what a per-layer metric moves, the cell reports
        assert m["moves"] in e2e


def test_layers_are_named_alike():
    names = {m["layer"] for m in MAN["per_layer"]}
    text = (harness.ROOT / "PERF.md").read_text()
    for n in names:
        assert n in text


@pytest.mark.parametrize("cell", CELLS)
def test_limits_set_for_every_compared_number(cell):
    lim = harness.workload(cell)["limits"]
    assert lim and all(isinstance(v, float) and v > 0 for v in lim.values())
