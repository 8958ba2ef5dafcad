"""Finds, by the names in ``BENCHMARK.json``, the files that belong to each
item of the benchmark:

- a cell: ``bench_port/workloads/<cell>.json`` (its configuration, batch,
  steps per call, process group, store rows, check limits);
- a configuration: ``bench_port/configs/<config>.json`` (sizes, source,
  ``reduced``, ``assumed``), which names the module that builds its
  program (``bench_port/programs/<family>.py``) and its plain reference
  (``bench_port/reference/<family>.py``);
- a per-layer metric: ``bench_port/metrics/<metric>.py``, with an optional
  data file ``bench_port/metrics/<metric>.json`` beside it.

A later change adds cells, configurations and metrics as new files and new
entries; nothing here needs an edit for them.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PACKAGE = HERE.name
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell ``name``: its file, with ``name`` added."""
    out = _json(HERE / "workloads" / f"{_name('cell', name)}.json")
    out["name"] = name
    return out


def config(name: str) -> dict:
    """The configuration ``name``: its file, with ``name`` added."""
    out = _json(HERE / "configs" / f"{_name('config', name)}.json")
    out["name"] = name
    return out


def _module(rel: str, kind: str):
    """The module of ``rel``, a path under this folder (``programs/x.py``)."""
    if not re.match(r"^[a-z][a-z0-9_]*/[a-z][a-z0-9_]*\.py$", rel):
        raise ValueError(f"bad {kind} path {rel!r}")
    if not (HERE / rel).is_file():
        raise FileNotFoundError(f"{kind} {rel} not found under {HERE}")
    return importlib.import_module(
        f"{PACKAGE}." + rel[:-3].replace("/", "."))


def program(cfg: dict):
    """The module that builds the program a configuration names."""
    return _module(cfg["program"], "program")


def reference(cfg: dict):
    """The plain reference that a configuration names."""
    return _module(cfg["reference"], "reference")


def metric(name: str):
    """The reader of the per-layer metric ``name``: a module with
    ``read(ctx) -> float | None``."""
    return _module(f"metrics/{_name('metric', name).replace('.', '_')}.py",
                   "metric")


def metric_data(name: str) -> dict:
    """The data file beside a metric's reader, or {} without one."""
    path = HERE / "metrics" / f"{_name('metric', name)}.json"
    return _json(path) if path.is_file() else {}


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics that a run of ``cell_name`` reports: the end-to-end ones
    without tracing, the per-layer ones with it, each kept where its
    ``workloads`` key lists the cell or where it has none."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def resolve_all(bench: dict | None = None) -> dict:
    """Every cell, configuration and metric of ``bench`` resolved to its
    files and modules (raises on the first that is missing)."""
    bench = bench or benchmark()
    out = {"cells": {}, "configs": {}, "metrics": {}}
    for c in bench["configs"]:
        cfg = config(c["name"])
        out["configs"][c["name"]] = (cfg, program(cfg), reference(cfg))
    for w in bench["workloads"]:
        out["cells"][w["name"]] = cell(w["name"])
    for m in bench["per_layer"]:
        out["metrics"][m["name"]] = metric(m["name"])
    return out
