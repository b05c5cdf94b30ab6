"""Finds a run's data by name: ``BENCHMARK.json`` at the root, the cell's
file under ``workloads/``, its configuration under ``configs/`` and each
metric's reader under ``metrics/``.  A new configuration, cell or metric is
a new file (and a new entry in ``BENCHMARK.json``); no file is edited."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CELL_KEYS = {"config", "mode", "local_batch", "loss_steps", "limits"}
LIMIT_KEYS = {"loss_gap", "grad_gap", "change_gap", "plan_mismatch"}


class BenchDataError(ValueError):
    """A benchmark data file is missing or malformed."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise BenchDataError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``workloads/<name>.json``: the cell's traffic (the mode and the local
    batch), the steps whose losses are compared and the limits of its output
    check."""
    data = _json(Path(bench_dir) / "workloads" / f"{name}.json")
    missing = CELL_KEYS - set(data)
    if missing:
        raise BenchDataError(f"cell {name}: missing keys {sorted(missing)}")
    if set(data["limits"]) != LIMIT_KEYS:
        raise BenchDataError(f"cell {name}: limits {sorted(data['limits'])}, "
                             f"want {sorted(LIMIT_KEYS)}")
    return data


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``configs/<name>.json``: the model, the graph, the sampler and the
    optimizer, with the source, the cuts and the assumed sizes."""
    data = _json(Path(bench_dir) / "configs" / f"{name}.json")
    for key in ("source", "reduced", "assumed", "model", "graph", "sampler", "optimizer"):
        if key not in data:
            raise BenchDataError(f"configuration {name}: missing key {key!r}")
    return data


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchDataError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "gnnbench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchDataError(f"BENCHMARK.json has no workload {name!r}")


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric with ``workloads`` is
    reported in those cells; an end-to-end metric without it in every
    cell, a per-layer one in every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
