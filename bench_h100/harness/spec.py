"""The benchmark's data and parts, found by name: ``BENCHMARK.json`` at
the checkout's root, ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json``, ``metrics/<metric>.py``, ``families/<family>.py``
(a configuration's ``"family"``) and ``clients/<client>.py`` (a mix's
``"client"``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def family(config: dict):
    """The module of the configuration's model family."""
    return importlib.import_module(f"bench_h100.families.{config['family']}")


def client(name: str):
    """The client class of ``clients/<name>.py``."""
    return importlib.import_module(f"bench_h100.clients.{name}").CLIENT


def limits(cell_name: str) -> dict:
    return json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())


def metrics(cell_name: str, traced: bool) -> list:
    """(name, unit, reader) of the cell's end-to-end metrics, or with
    ``traced`` its per-layer ones: those that list the cell, or list no
    cells."""
    spec = benchmark()
    out = []
    for m in spec["per_layer" if traced else "end_to_end"]:
        if cell_name in m.get("workloads", [cell_name]):
            out.append((m["name"], m["unit"], reader(m["name"])))
    return out


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
