"""``python -m repro_torch.analysis`` -- run the static invariant checker
(port of ``repro.analysis.cli``).

Examples::

    python -m repro_torch.analysis src/repro_torch                 # all passes, on the card
    python -m repro_torch.analysis src/repro_torch --device cpu    # all passes, on the CPU
    python -m repro_torch.analysis src/repro_torch --device cpu --format json
    python -m repro_torch.analysis tests/fixtures/analysis_torch/bad_key_reuse.py --passes lint
    python -m repro_torch.analysis src/repro_torch --passes lint,contracts --fail-on warning

Exit code is 1 when any finding at or above ``--fail-on`` severity
(default ``error``) survives, else 0.  The contracts and trace passes
run on CUDA unless ``--device cpu`` is given; the lint pass needs no
device.  The reference's ``--vmem-budget`` has no counterpart: it sizes
the Pallas VMEM check (RA106), which the CUDA kernels do not have.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Iterable, Optional

from repro_torch.analysis.findings import Report, Severity

PASSES = ("lint", "contracts", "trace")


def _package_dir() -> str:
    import repro_torch

    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def _covers_package(paths: Iterable[str]) -> bool:
    pkg = _package_dir()
    for p in paths:
        a = os.path.abspath(p)
        if pkg == a or pkg.startswith(a.rstrip(os.sep) + os.sep) \
                or a.startswith(pkg.rstrip(os.sep) + os.sep):
            return True
    return False


def run_analysis(
    paths: Iterable[str],
    passes: Iterable[str] = PASSES,
    device=None,
) -> Report:
    """Programmatic entry point; returns a :class:`Report`.

    ``device`` (CUDA unless ``"cpu"``) is where the contracts and trace
    passes run; it is resolved only when one of them runs.
    """
    from repro_torch.analysis.lint import run_lint

    paths = [str(p) for p in paths]
    passes = list(passes)
    report = Report()
    t0 = time.perf_counter()

    if "lint" in passes:
        findings, n_files = run_lint(paths)
        report.extend(findings)
        report.files_scanned += n_files
        report.passes_run.append("lint")
    if "contracts" in passes or "trace" in passes:
        from repro_torch.device import resolve_device

        device = resolve_device(device)
    if "contracts" in passes:
        from repro_torch.analysis.contracts import run_contracts

        report.extend(run_contracts(paths, device))
        report.passes_run.append("contracts")
    if "trace" in passes:
        # the trace pass exercises live port entry points, so it only
        # fires when the analyzed paths cover the repro_torch package
        if _covers_package(paths):
            from repro_torch.analysis.trace import run_trace

            report.extend(run_trace(device))
            report.passes_run.append("trace")

    report.wall_s = time.perf_counter() - t0
    return report


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checker: AST lint (RA0xx), kernel "
                    "contracts (RA1xx), trace hygiene (RA2xx).",
    )
    ap.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files or directories to analyze (default: src/repro_torch)",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (default: text)",
    )
    ap.add_argument(
        "--passes", default=",".join(PASSES),
        help=f"comma-separated subset of {{{','.join(PASSES)}}} "
             "(default: all)",
    )
    ap.add_argument(
        "--fail-on", default="error", metavar="SEVERITY",
        help="minimum severity that fails the run: info|warning|error "
             "(default: error)",
    )
    ap.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="where the contracts and trace passes run: cuda (default) or cpu",
    )
    ap.add_argument(
        "--output", default=None, metavar="FILE",
        help="also write the report (in the chosen format) to FILE",
    )
    args = ap.parse_args(argv)

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        ap.error(f"unknown pass(es): {', '.join(unknown)}")
    for p in args.paths:
        if not os.path.exists(p):
            ap.error(f"path does not exist: {p}")
    fail_on = Severity.parse(args.fail_on)
    device = args.device
    if "contracts" in passes or "trace" in passes:
        from repro_torch.device import resolve_device

        try:
            device = resolve_device(device)
        except (RuntimeError, ValueError) as e:  # no card, or no such device
            ap.error(str(e))

    report = run_analysis(args.paths, passes=passes, device=device)
    rendered = (
        report.render_json() if args.format == "json" else report.render_text()
    )
    print(rendered)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(rendered + "\n")
    return report.exit_code(fail_on)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
