"""BENCHMARK.json against the benchmark's contract, and the data-driven
loader: a new configuration, cell and metric are files of their own that the
harness finds by name, with no file that is there edited."""
import hashlib
import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from gnnbench import loader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract(bench_json):
    b = bench_json
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "bench/run.py"] and b["paths"] == ["bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["why"]) and _one_line(c["source"])
        assert c["file"] == f"bench/configs/{c['name']}.json" and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]) and cfg["source"] == c["source"]
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24 and len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    assert {w["config"] for w in cells} == set(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    per = b["per_layer"]
    assert 1 <= len(per) <= 128
    assert len({m["name"] for m in per} | set(e2e)) == len(per) + len(e2e)
    for m in b["end_to_end"] + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in per:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _one_line(m["layer"]) and m["moves"] in e2e
        assert all(w in {c["name"] for c in cells} for w in m.get("workloads", []))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        rep = loader.metrics_for(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in rep} and len(rep) >= 2
        assert loader.metrics_for(b, w["name"], True)


def test_every_named_file_is_there(bench_json):
    for w in bench_json["workloads"]:
        cell = loader.cell(w["name"])
        assert cell["config"] == w["config"]
        loader.config(cell["config"])
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        assert callable(loader.reader(m["name"]))


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_cell_and_metric_need_no_edit(tiny):
    from gnnbench import harness

    root, bench = tiny
    before = _digest(root)
    cfg = json.loads((bench / "configs" / "gcn-papers100m.json").read_text())
    cfg["graph"]["scale"] = 9
    (bench / "configs" / "gcn-small.json").write_text(json.dumps(cfg))
    cell = json.loads((bench / "workloads" / "gcn-papers100m.coop.json").read_text())
    cell["config"] = "gcn-small"
    (bench / "workloads" / "gcn-small.coop.json").write_text(json.dumps(cell))
    (bench / "metrics" / "window_steps.py").write_text(
        "def read(ctx):\n    return ctx['window']['steps']\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    new = dict(b)
    new["configs"] = b["configs"] + [dict(b["configs"][0], name="gcn-small",
                                          file="bench/configs/gcn-small.json")]
    new["workloads"] = b["workloads"] + [dict(b["workloads"][0], name="gcn-small.coop",
                                              config="gcn-small")]
    new["per_layer"] = b["per_layer"] + [{"name": "window_steps", "unit": "steps",
                                          "better": "higher", "source": "host_clock",
                                          "layer": "train loop", "moves": "seeds_per_s",
                                          "workloads": ["gcn-small.coop"]}]
    # the copy's BENCHMARK.json gains entries; no file of the benchmark is edited
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    out = harness.run("gcn-small.coop", 3, 0.2, True, device="cpu", bench_dir=bench, root=root)
    assert out["correct"] and out["metrics"]["window_steps"]["value"] == out["attempted"]
    after = _digest(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {p for p in before if p.name == "BENCHMARK.json"}


def test_a_missing_or_malformed_file_is_refused(tiny):
    root, bench = tiny
    with pytest.raises(loader.BenchDataError):
        loader.cell("no-such-cell", bench)
    bad = json.loads((bench / "workloads" / "gcn-papers100m.coop.json").read_text())
    del bad["limits"]["plan_mismatch"]
    (bench / "workloads" / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(loader.BenchDataError):
        loader.cell("bad", bench)
    with pytest.raises(loader.BenchDataError):
        loader.reader("no_such_metric", bench)
    shutil.rmtree(bench / "configs")
    with pytest.raises(loader.BenchDataError):
        loader.config("gcn-papers100m", bench)
