"""CPU tests of the benchmark harness (``python -m pytest bench/tests``).

They run the harness end to end at a tiny size on the CPU, where the port
takes the plain versions of its kernels and runs its programs eagerly.
Tests marked ``gpu`` need a card and decide inside the test.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny stand-in of each configuration: the shapes kept, the sizes cut
TINY_GRAPH = {"scale": 10, "edge_factor": 8, "max_degree": 16, "train_fraction": 0.5}
TINY_MODEL = {"in_dim": 16, "hidden_dim": 32}
TINY_CELL = {"local_batch": 8}


def make_tree(dest: Path) -> Path:
    """A copy of the benchmark at a tiny size under ``dest``: ``BENCHMARK.json``
    and ``bench/`` with every configuration and cell cut down; returns the
    copy's ``bench`` directory."""
    bench = dest / "bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for sub in ("configs", "workloads"):
        (bench / sub).mkdir(parents=True)
    for f in (BENCH / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["graph"].update(TINY_GRAPH)
        cfg["model"].update(TINY_MODEL)
        (bench / "configs" / f.name).write_text(json.dumps(cfg))
    for f in (BENCH / "workloads").glob("*.json"):
        cell = json.loads(f.read_text())
        cell.update(TINY_CELL)
        (bench / "workloads" / f.name).write_text(json.dumps(cell))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return bench


@pytest.fixture
def tiny(tmp_path):
    """``(root, bench_dir)`` of a tiny copy of the benchmark."""
    return tmp_path, make_tree(tmp_path)


@pytest.fixture
def run_tiny(tiny):
    """``run(cell, seed=..., seconds=..., trace=...)`` of the harness on the CPU
    over the tiny copy; returns ``(result, stderr lines)``."""
    import io

    from gnnbench import harness

    root, bench = tiny

    def run(cell, seed=7, seconds=0.2, trace=False):
        log = io.StringIO()
        out = harness.run(cell, seed, seconds, trace, device="cpu", bench_dir=bench,
                          root=root, log=log)
        return out, log.getvalue().splitlines()

    return run


@pytest.fixture
def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
