#!/usr/bin/env python3
"""One run of a benchmark cell as ``bench/run.py`` makes it, with the step
program's spans switched off or the traced window's Chrome trace kept:

    python3 tools/bench_variant.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--spans 0|1] [--save-trace PATH]

``--spans 0`` builds the step program with ``spans=False`` (the bare
graph), so that runs with and without the markers can be compared in
turns on one card.  ``--save-trace PATH`` (a traced run) copies the
profiled steps' Chrome trace to ``PATH`` and writes beside it
``PATH.spans.json``: the device seconds of every kernel put down to the
innermost span it ran in (``gnnbench.spans.kernels_by_span``; ``null``:
in none).  The result line and the exit code are ``bench/run.py``'s.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--save-trace", default=None)
    args, rest = ap.parse_known_args(argv)
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    spec = importlib.util.spec_from_file_location("bench_run", ROOT / "bench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)

    from gnnbench import spans, traces
    from repro_torch.train import loop

    if not args.spans:
        loop.step_program = functools.partial(loop.step_program, spans=False)
    if args.save_trace:
        load = traces.load

        def keep(path: str):
            shutil.copy(path, args.save_trace)
            tr = load(path)
            by_span = spans.kernels_by_span(tr)
            Path(args.save_trace + ".spans.json").write_text(
                json.dumps({str(k): v for k, v in by_span.items()}, indent=1))
            return tr

        traces.load = keep
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
