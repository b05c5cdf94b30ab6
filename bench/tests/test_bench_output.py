"""The shape of a run's result line and of its last lines on standard error."""
import json

import pytest

from gnnbench import loader

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _check_lines(out, lines):
    tail = lines[-len(out["checks"]):]
    assert tail == [f"check {k} {c['value']!r} limit {c['limit']!r}"
                    for k, c in out["checks"].items()]


def test_untraced_line(run_tiny, bench_json):
    out, lines = run_tiny("gcn-papers100m.coop")
    assert list(out) == KEYS + ["checks"]  # the checks' key comes last
    assert json.loads(json.dumps(out)) == out
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == loader.LIMIT_KEYS
    want = {m["name"]: m["unit"] for m in loader.metrics_for(bench_json, "gcn-papers100m.coop",
                                                               False)}
    # on the CPU the allocator reports no peak, so peak_mem_gib stays out
    assert set(out["metrics"]) == set(want) - {"peak_mem_gib"}
    for name, m in out["metrics"].items():
        assert m["unit"] == want[name] and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    _check_lines(out, lines)


@pytest.mark.parametrize("cell", ["rgcn-mag240m.coop", "gcn-papers100m.indep"])
def test_traced_line(run_tiny, cell):
    out, lines = run_tiny(cell, trace=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for rows in out["breakdown"].values():
        assert len(rows) <= 10 and all(isinstance(n, str) and v >= 0 for n, v in rows)
    # the readers that need no card read on the CPU too
    assert {"step_mfu", "input_rows_per_seed"} <= set(out["metrics"])
    assert 0 < out["metrics"]["step_mfu"]["value"] < 100
    _check_lines(out, lines)
