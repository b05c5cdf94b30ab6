"""The port's static analyzer (``python -m repro_torch.analysis``) vs the
JAX package's (``repro.analysis``), on the CPU.

* Findings, suppression comments and reports: ``suppressed_rules`` gives
  the reference's result on the same strings, and ``Finding.to_dict`` /
  ``Report.to_dict`` carry the reference's keys.
* Each torch twin under ``tests/fixtures/analysis_torch/`` of a
  reference fixture under ``tests/fixtures/analysis/`` (defect on the
  same line) gives the reference's rule ids and lines.
* RA005 on a kernel module with a bare ``assert``; RA107 on a wrapper
  that accepts a bad input or raises a plain ``ValueError``.
* The trace pass: RA201 on an entry whose second call changes a shape,
  RA202 on one that calls ``.item()``, RA299 on one that raises, RA200
  on a clean one.
* The CLI's JSON and exit codes, and the port's own ``src/repro_torch``
  (all passes, ``--device cpu``, in a process that must import neither
  JAX nor ``repro``): no RA005, RA107, RA199 or RA299, and RA100 for all
  seven kernel wrappers.  Its RA001/RA002/RA004 findings are reported,
  not suppressed.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import run_analysis as j_run_analysis
from repro_torch.analysis import Finding, Report, Severity, findings, main, run_analysis
from repro_torch.analysis.lint import HOT_SCOPES, build_context
from repro_torch.analysis.trace import TraceEntry, record_call, run_trace

torch.set_num_threads(1)  # the suite runs files in parallel workers

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis_torch"
REF_FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
WRAPPERS = {
    "gather_cuda": "src/repro_torch/kernels/gather/ops.py",
    "unique_compact_cuda": "src/repro_torch/kernels/unique_compact/ops.py",
    "frontier_gather_cuda": "src/repro_torch/kernels/frontier_gather/ops.py",
    "expand_indptr_cuda": "src/repro_torch/kernels/expand_indptr/ops.py",
    "spmm_cuda": "src/repro_torch/kernels/spmm/ops.py",
    "seg_softmax_cuda": "src/repro_torch/kernels/seg_softmax/ops.py",
    "tag_probe_cuda": "src/repro_torch/store/kernel.py",
}
TRACE_ENTRIES = (
    "kernels.gather", "kernels.spmm", "kernels.seg_softmax", "graph.neighbor_table",
    "engine.build_plan[smoothed]", "engine.plan_at[nested]", "serve.hot_path[bucket=8]",
)
CPU = torch.device("cpu")


@pytest.mark.parametrize("line", [
    "x = f()  # ra: ignore",
    "x = f()  # ra: ignore[RA001]",
    "x = f()  #ra:ignore[ra001, RA003 ]",
    "x = f()  # repro-analysis: ignore[RA002,RA004]",
    "x = f()  # ra: ignore[]",
    "x = f()  # noqa",
    "x = f()",
])
def test_suppressed_rules_matches_reference(line):
    assert findings.suppressed_rules(line) == jfindings.suppressed_rules(line)
    f = Finding("RA001", Severity.ERROR, "m", "a.py", 1)
    jf = jfindings.Finding("RA001", jfindings.Severity.ERROR, "m", "a.py", 1)
    assert findings.is_suppressed(f, [line]) == jfindings.is_suppressed(jf, [line])


def test_report_keys_and_rendering_match_reference():
    rows = [("RA001", "ERROR", "a.py", 3), ("RA100", "INFO", "b.py", 0),
            ("RA202", "WARNING", "c.py", 7)]
    port = Report(findings=[Finding(r, Severity[s], "msg", f, l, extra={"k": 1})
                            for r, s, f, l in rows], passes_run=["lint"], files_scanned=2)
    ref = jfindings.Report(findings=[
        jfindings.Finding(r, jfindings.Severity[s], "msg", f, l, extra={"k": 1})
        for r, s, f, l in rows], passes_run=["lint"], files_scanned=2)
    assert port.to_dict() == ref.to_dict()
    assert json.loads(port.render_json()) == json.loads(ref.render_json())
    assert port.render_text().replace("repro_torch.analysis", "repro.analysis") == \
        ref.render_text()
    for sev in ("info", "warning", "error"):
        assert port.exit_code(Severity.parse(sev)) == ref.exit_code(
            jfindings.Severity.parse(sev))


def _rule_lines(report) -> list:
    return sorted((f.rule, f.line) for f in report.findings)


@pytest.mark.parametrize("name", ["bad_key_reuse", "bad_numpy_hot", "clean"])
def test_twin_fixture_matches_reference(name):
    got = run_analysis([str(FIXTURES / f"{name}.py")], passes=["lint", "contracts"],
                       device="cpu")
    want = j_run_analysis([str(REF_FIXTURES / f"{name}.py")], passes=["lint", "contracts"])
    assert _rule_lines(got) == _rule_lines(want)
    assert _rule_lines(got), name  # every twin gives a finding (clean: RA100)


def test_bare_assert_in_kernel_module():
    rep = run_analysis([str(FIXTURES / "bad_assert_kernel.py")], passes=["lint"])
    assert _rule_lines(rep) == [("RA005", 12)]
    assert rep.exit_code() == 1


def test_untyped_preconditions_are_ra107():
    rep = run_analysis([str(FIXTURES / "bad_contract.py")], passes=["contracts"],
                       device="cpu")
    rules = [f.rule for f in rep.findings]
    assert rules == ["RA107", "RA107"]
    raised, silent = rep.findings
    assert raised.extra == {"raised": "ValueError"} and "accepted silently" in silent.message


def test_hot_scope_table_names_existing_functions():
    for rel, names in HOT_SCOPES.items():
        path = ROOT / "src" / "repro_torch" / rel
        ctx = build_context(str(path), path.read_text())
        defined = set()

        def walk(node, prefix):
            for child in getattr(node, "body", []):
                if type(child).__name__ in ("FunctionDef", "AsyncFunctionDef", "ClassDef"):
                    defined.add(prefix + child.name)
                    walk(child, prefix + child.name + ".")

        walk(ctx.tree, "")
        assert set(names) <= defined, (rel, set(names) - defined)
        hot = {fn.name for fn in ctx.hot_functions}
        assert {n.rsplit(".", 1)[-1] for n in names} <= hot, rel


def _entry(name, fn, *variants):
    return TraceEntry(name, "synthetic.py", lambda device: (fn, list(variants)))


def test_trace_reports_shape_drift_syncs_and_failures():
    shrinks = _entry("drift", lambda x: x[: int(x.shape[0] > 4) + 2] * 2,
                     lambda: ((torch.ones(3),), {}), lambda: ((torch.ones(8),), {}))
    reads = _entry("item", lambda x: x * x.sum().item(),
                   lambda: ((torch.ones(4),), {}), lambda: ((torch.zeros(4),), {}))
    clean = _entry("clean", lambda x: torch.where(x > 0, x, 0) + 1,
                   lambda: ((torch.ones(4),), {}), lambda: ((-torch.ones(4),), {}))
    broken = TraceEntry("broken", "synthetic.py", lambda device: 1 / 0)
    got = {(f.extra.get("entry", "broken"), f.rule): f
           for f in run_trace(CPU, [shrinks, reads, clean, broken])}
    assert set(got) == {("drift", "RA201"), ("item", "RA202"), ("clean", "RA200"),
                        ("broken", "RA299")}
    assert got[("drift", "RA201")].extra["same_signature"] is False
    calls = got[("item", "RA202")].extra["calls"]
    assert [c["scalar_reads"] for c in calls] == [1, 1]
    (site, n), = calls[0]["sites"].items()
    assert n == 1 and site.startswith("aten._local_scalar_dense.default @ test_torch_analysis.py:")
    assert calls[0]["sync_warnings"] is None  # counted only on a card


def test_record_call_counts_value_shaped_ops():
    x, m = torch.arange(10), torch.arange(10) % 3 == 0

    def fn():
        y = x[m]                      # boolean indexing
        u = torch.unique(x)           # unique
        n = torch.nonzero(m)          # nonzero
        r = torch.repeat_interleave(torch.ones(2, dtype=torch.long))
        s = torch.repeat_interleave(x[:2], 2, output_size=4)  # sized: no sync
        return y, u, n, r, s, bool(m.any())

    _, rec = record_call(CPU, fn)
    assert (rec.value_shaped, rec.scalar_reads, rec.d2h_copies) == (4, 1, 0)
    assert rec.syncs == 5


def test_cli_json_and_exit_codes(capsys, tmp_path):
    bad = str(FIXTURES / "bad_key_reuse.py")
    assert main([bad, "--passes", "lint", "--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"passes", "files_scanned", "wall_s", "rule_counts", "counts",
                        "findings"}
    assert out["rule_counts"] == {"RA003": 1} and out["passes"] == ["lint"]
    assert out["findings"][0]["line"] == 8
    clean = str(FIXTURES / "clean.py")
    dest = tmp_path / "report.txt"
    assert main([clean, "--device", "cpu", "--output", str(dest)]) == 0
    assert "1 info" in dest.read_text()
    assert main([clean, "--device", "cpu", "--fail-on", "info"]) == 1
    capsys.readouterr()
    for argv in ([clean, "--passes", "lint,bogus"], [str(tmp_path / "missing.py")],
                 [clean, "--device", "nowhere"]):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2


@pytest.fixture(scope="module")
def port_report(tmp_path_factory):
    """The whole port through the CLI in a fresh process, on the CPU."""
    out = tmp_path_factory.mktemp("analysis") / "port.json"
    code = (
        "import sys\n"
        "from repro_torch.analysis.cli import main\n"
        f"rc = main(['src/repro_torch', '--device', 'cpu', '--format', 'json', "
        f"'--output', {str(out)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('IMPORTED', bad, file=sys.stderr)\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=240,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                               "OMP_NUM_THREADS": "1"})
    return proc, json.loads(out.read_text())


def test_port_analysis_imports_no_jax(port_report):
    proc, rep = port_report
    assert "IMPORTED []" in proc.stderr, proc.stderr[-2000:]
    assert proc.returncode == 1  # the lint and trace findings below are errors
    assert rep["passes"] == ["lint", "contracts", "trace"]


def test_port_kernel_contracts_verified(port_report):
    _, rep = port_report
    rules = rep["rule_counts"]
    for rule in ("RA005", "RA107", "RA199", "RA299", "RA999"):
        assert rule not in rules, (rule, [f for f in rep["findings"] if f["rule"] == rule])
    verified = {f["message"].split("`")[1]: f["file"] for f in rep["findings"]
                if f["rule"] == "RA100"}
    assert set(verified) == set(WRAPPERS)
    for fn, path in WRAPPERS.items():
        assert verified[fn].endswith(path)


def test_port_trace_and_hot_path_findings(port_report):
    _, rep = port_report
    entries = {f["extra"]["entry"] for f in rep["findings"]
               if f["rule"] in ("RA200", "RA201", "RA202")}
    assert entries == set(TRACE_ENTRIES)
    hot = [(f["rule"], f["file"], f["line"]) for f in rep["findings"]
           if f["rule"] in ("RA001", "RA002", "RA004")]
    assert hot  # reported, not suppressed: the plan build's worklist
    # the fixed-shape tiered store and the device-step Adam read nothing on
    # the host and run no host numpy inside their programs
    files = {f for _, f, _ in hot}
    for path in ("store/clock.py", "store/tiers.py", "train/optim.py"):
        assert f"src/repro_torch/{path}" not in files, [h for h in hot if path in h[1]]
