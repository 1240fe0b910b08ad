"""BENCHMARK.json and every file it names, found by name, within the
limits of the benchmark's contract (CPU only, no card needed)."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _names():
    out = [c["name"] for c in SPEC["configs"]]
    out += [w["name"] for w in SPEC["workloads"]]
    out += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    out += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    out += [k for c in SPEC["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"],
                  SPEC["end_to_end"] + SPEC["per_layer"]):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))


def test_metrics_keys_units_sources_and_bounds():
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in e2e
        assert LINE.match(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for cell in m.get("workloads", ()):
            assert cell in CELLS


def test_configs_and_cells_entries():
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_by_name(name):
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    own = json.loads((ROOT / "portbench" / "workloads" /
                      f"{name}.json").read_text())
    assert own == {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    cell = harness.load_cell(name)
    assert cell.chips == entry["chips"]
    for key in ("dataset", "n", "dims", "eps", "min_pts", "reference",
                "guarantees", "assumed"):
        assert key in cell.config
    for key in ("op", "pool", "min_pts", "trace_calls"):
        assert key in cell.traffic
    op = harness.load_op(cell.traffic["op"])
    assert callable(op.setup) and callable(op.call)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    # every per-layer metric of the cell moves an end-to-end one it reports
    assert all(m["moves"] in names for m in cell.per_layer)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]))


def test_every_file_under_paths_is_named_from_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or path.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert len(rel) <= 200
