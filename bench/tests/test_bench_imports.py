"""No module of JAX or of the JAX package in what the benchmark loads, and the
exit codes of a run that must print no result."""
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT
from gnnbench.imports import forbidden_modules


def test_top_level_names_compared_whole():
    names = ["repro_torch", "repro_torch.core", "reproduce", "jaxtyping", "torch",
             "repro", "repro.core.graph", "jax", "jax.numpy", "jaxlib.xla", "flax.linen"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla", "repro",
                                        "repro.core.graph"]


def _python(code, cwd=ROOT, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600, **kw)


def test_a_whole_run_loads_nothing_of_jax(tmp_path):
    code = f"""
import sys, json
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}, {str(BENCH / 'tests')!r}]
from pathlib import Path
import conftest
from gnnbench import harness, faults
from gnnbench.imports import forbidden_modules
import control, run
root = Path({str(tmp_path)!r})
bench = conftest.make_tree(root)
out = harness.run("rgcn-mag240m.coop", 4, 0.1, True, device="cpu", bench_dir=bench, root=root)
print(json.dumps(forbidden_modules()))
"""
    res = _python(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "gcn-papers100m.coop", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 3 and res.stdout == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", "gcn-papers100m.coop",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
