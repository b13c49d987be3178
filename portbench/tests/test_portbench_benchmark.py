"""The benchmark's own files: ``BENCHMARK.json`` against the contract's
form, and every name it gives leading to a file."""

from __future__ import annotations

import json
import re

import pytest

from portbench.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _e2e_of(cell):
    return {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def _layer_of(cell):
    names = _e2e_of(cell)
    return [m for m in BENCH["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_one_line_texts(kind):
    seen = set()
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        assert e["name"] not in seen
        seen.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_entries_have_just_the_contract_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}
    for kind, keys in allowed.items():
        for e in BENCH[kind]:
            assert set(e) <= keys, (kind, e["name"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25


def test_every_name_leads_to_its_file():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("portbench/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
    for w in BENCH["workloads"]:
        tr = json.loads((ROOT / "portbench" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        assert w["traffic"] == w["name"]
        assert (ROOT / "portbench" / "drivers"
                / f"{tr['driver']}.py").is_file()
        assert w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "layer_metrics"
                / f"{m['name']}.py").is_file()


def test_each_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m.get("workloads", []):
            assert cell in cells
            assert m["moves"] in _e2e_of(cell), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = _e2e_of(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert _layer_of(cell)


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
