"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from lmibench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  for p in BENCH["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert spec.NAME.match(entry["name"])
    for key in ("why", "layer"):
        if key in entry:
            assert LINE.match(entry[key]), key
    if "file" in entry:  # a configuration's source
        assert LINE.match(entry["source"])
    if "unit" in entry:
        assert spec.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_and_matches(conf):
    assert conf["file"] == f"lmibench/configs/{conf['name']}.json"
    data = spec.config(conf["name"])
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] and len(conf["reduced"]) <= 16
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    assert traffic["kind"] in ("closed_loop", "open_loop")
    limits = spec.limits(cell["name"])
    from lmibench.check import NUMBERS
    assert set(limits) == set(NUMBERS)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert callable(spec.metric_module(metric["name"]).read)
    if metric in BENCH["end_to_end"]:
        assert 0 < metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert LINE.match(metric["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    layers = spec.per_layer(BENCH, cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], cell)


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(len(CELLS) // 4, 1)


def test_layer_names_agree():
    layers = {}
    for m in BENCH["per_layer"]:
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
