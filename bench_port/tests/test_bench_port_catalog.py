"""``BENCHMARK.json`` resolves to its files, and keeps the format's limits."""
import json
import re

import pytest

from bench_port import catalog, check

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = catalog.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_item_resolves_to_its_files():
    found = catalog.resolve_all(BENCH)
    assert set(found["cells"]) == set(CELLS)
    assert set(found["configs"]) == {c["name"] for c in BENCH["configs"]}
    for name, module in found["metrics"].items():
        assert callable(module.read), name


@pytest.mark.parametrize("name", CELLS)
def test_cell_file_matches_its_entry(name):
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    cell = catalog.cell(name)
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    assert cell["why"] == entry["why"]
    assert entry["chips"] == 1
    assert set(cell["limits"]) <= set(check.NUMBERS)
    assert all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_names_its_file(entry):
    assert entry["file"] == f"bench_port/configs/{entry['name']}.json"
    cfg = catalog.config(entry["name"])
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for name in CELLS:
        e2e = catalog.metrics_of(BENCH, name, trace=False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert catalog.metrics_of(BENCH, name, trace=True)
