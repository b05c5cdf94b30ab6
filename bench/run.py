"""Benchmark of the PyTorch and CUDA port (``repro_torch``): one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The cell's
files (``bench/workloads/<cell>.json``, its configuration under
``bench/configs/`` and the readers under ``bench/metrics/``) are found by
name through ``BENCHMARK.json``.  The last line of standard output is the
result as one JSON object; the last lines of standard error give each
number of the output check beside its limit.  Exit codes: 0 a result
printed (``correct`` may be false); 2 the checkout lacks the port; 3 no
CUDA device, or fewer than the cell asks for; 4 JAX or the JAX package
was loaded.  Nothing here imports JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# compile caches at fixed paths inside the checkout, so only a checkout's
# first run of a cell builds (the port's nvcc libraries go to
# build/torch_kernels/ by themselves)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch beside {BENCH}: this checkout lacks the system under test",
              file=sys.stderr)
        return 2
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    from gnnbench import harness, loader
    from gnnbench.imports import forbidden_modules

    chips = loader.workload_entry(loader.benchmark(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_start=T_START)
    except harness.RunError as e:
        print(e, file=sys.stderr)
        return e.code
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
