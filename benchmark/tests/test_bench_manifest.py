"""``BENCHMARK.json`` against the benchmark's files and the contract's
shapes: every name found by the harness, every name and unit in the allowed
characters, each cell reporting what it must."""

import json
import math
import re

import pytest

from benchmark.harness.cell import BENCH_DIR, ROOT, Cell, load_json

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s of compiling a cell, 1200 s spare, within 43200 s.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_keys(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = load_json(ROOT / config["file"])
    assert config["file"].startswith("benchmark/configs/")
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] and "assumed" in data
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_parts(name):
    cell = Cell.by_name(name)
    assert cell.entry["chips"] == 1
    assert cell.spec["config"] == cell.entry["config"]
    assert cell.spec["traffic"] == cell.entry["traffic"]
    driver = cell.driver()
    for fn in ("setup", "step", "end_to_end", "work", "check"):
        assert callable(getattr(driver, fn))
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
        assert m["moves"] in e2e
    # A limit is above 0, or 0 for an exact comparison (``*_rerun_gap``).
    assert all(math.isfinite(v) and (v > 0 or k.endswith("_rerun_gap"))
               for k, v in cell.spec["limits"].items())


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert len(layer) <= 200
    roof = [m for m in BENCH["per_layer"] if m["name"].split(".")[0].endswith("_roofline")]
    assert roof and all(m["unit"] == "%" for m in roof)
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_file_names():
    allowed = re.compile(r"^[A-Za-z0-9_.-]+$")
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.suffix == ".pyc":
            continue
        assert all(allowed.match(part) for part in path.relative_to(ROOT).parts), path
