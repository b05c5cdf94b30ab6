"""The readers of the program's spans and counters on a hand-made Chrome trace:
marker pairing, device idle inside ``engine.step_state``, blocking runtime
calls inside the program's host spans, and ``None`` from every new reader
where its inputs are absent (a CPU trace, a program without spans)."""
import json

import pytest

from conftest import BENCH
from gnnbench import loader, spans, traces

NEW = ("exchange_ms", "exchange_fill", "step_plan_ms", "upload_idle_ms",
       "host_syncs_per_step", "step_input_rows_per_seed")
INDEX_PUT = "void at::native::index_elementwise_kernel<128, 4>(int, F)"


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _k("bench.traced", 0, 10000, "user_annotation"),
    # the plan: begin marker, the id exchange of layer 0 inside it, an index_put
    _k("span_plan", 100, 2), _k("span_exchange_ids_l0", 200, 1),
    _k("span_exchange_ids_l0", 300, 1), _k(INDEX_PUT, 400, 200), _k("span_plan", 1000, 2),
    # the forward exchange of layer 1, an index_put inside it
    _k("span_exchange_fwd_l1", 2000, 2), _k(INDEX_PUT, 2100, 200),
    _k("span_exchange_fwd_l1", 2500, 2),
    # a marker without its pair is no span
    _k("span_adam", 5000, 1),
    # the step state's upload: the device busy 3100-3200 only
    _k(spans.STEP_STATE, 3000, 500, "user_annotation"),
    _k("cudaHostAlloc", 3050, 10, "cuda_runtime"),
    _k("some_kernel", 3100, 100),
    _k("train_step.replay", 3500, 500, "user_annotation"),
    _k("cudaStreamSynchronize", 3600, 100, "cuda_runtime"),
    _k("cudaMemcpyAsync", 3700, 10, "cuda_runtime"),
    _k("cudaMemcpy", 3720, 10, "cuda_runtime"),
    _k("cudaGraphLaunch", 3740, 10, "cuda_runtime"),
    _k("cudaDeviceSynchronize", 8000, 100, "cuda_runtime"),  # outside the program's spans
    _k("span_plan", 20000, 2),  # outside the window
]


def _load(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return traces.load(str(path))


@pytest.fixture
def trace(tmp_path):
    return _load(tmp_path, EVENTS)


def _ctx(tr, report=None, steps=(7, 8)):
    return {"trace": tr, "profiled_steps": list(steps), "program_report": report or {}}


def _read(name, ctx):
    return loader.reader(name, BENCH)(ctx)


def test_markers_pair_by_name_inside_the_window(trace):
    got = spans.markers(trace)
    assert got == {"plan": [(102, 1000)], "exchange_ids_l0": [(201, 300)],
                   "exchange_fwd_l1": [(2002, 2500)]}
    assert spans.span_ms(trace, "plan", 2) == pytest.approx(0.898 / 2)
    assert spans.span_ms(trace, r"exchange_\w+", 1) == pytest.approx(0.099 + 0.498)
    assert spans.span_ms(trace, "adam", 1) is None


def test_kernels_are_put_down_to_their_innermost_span(trace):
    got = spans.kernels_by_span(trace)
    name = traces.short_name(INDEX_PUT)
    assert got["plan"] == {name: pytest.approx(200e-6)}
    assert got["exchange_fwd_l1"] == {name: pytest.approx(200e-6)}
    assert got[None] == {"some_kernel": pytest.approx(100e-6)}


def test_readers_on_the_trace(trace):
    ctx = _ctx(trace)
    assert _read("exchange_ms", ctx) == pytest.approx((0.099 + 0.498) / 2)
    assert _read("step_plan_ms", ctx) == pytest.approx(0.898 / 2)
    # idle 3000-3100 and 3200-3500 inside engine.step_state
    assert _read("upload_idle_ms", ctx) == pytest.approx(0.4 / 2)
    # cudaHostAlloc, cudaStreamSynchronize and cudaMemcpy; not the async
    # copy, the launch or the sync outside the program's spans
    assert _read("host_syncs_per_step", ctx) == pytest.approx(3 / 2)


def test_exchange_fill_from_the_counters():
    report = {256: {"capture_ms": 1.0, "counters": {
        "exchange.valid_bytes.l0": 10, "exchange.slot_bytes.l0": 100,
        "exchange.valid_bytes.l1": 30, "exchange.slot_bytes.l1": 300, "input_rows": 5}}}
    assert _read("exchange_fill", _ctx(None, report)) == pytest.approx(10.0)


def test_step_input_rows_per_seed_from_the_counters():
    report = {256: {"capture_ms": 1.0, "counters": {"replays": 4, "input_rows": 4 * 3000}}}
    ctx = {**_ctx(None, report), "global_batch": 1000}
    assert _read("step_input_rows_per_seed", ctx) == pytest.approx(3.0)
    report[256]["counters"] = {"replays": 4}
    assert _read("step_input_rows_per_seed", ctx) is None


def test_every_new_reader_is_silent_without_its_inputs(tmp_path):
    # a CPU trace: host events only; and a program without spans or counters
    cpu = _load(tmp_path, [e for e in EVENTS if e["cat"] != "kernel"])
    parent = _load(tmp_path, [e for e in EVENTS if not e["name"].startswith("span_")
                              and e["name"] not in (spans.STEP_STATE, "train_step.replay")])
    report = {256: {"capture_ms": 1.0, "pool_bytes": 2, "launches": {}, "programs": 1}}
    for tr in (None, cpu, parent):
        for name in NEW:
            assert _read(name, _ctx(tr, report)) is None, (name, tr)
    assert _read("exchange_fill", _ctx(None, {})) is None


def test_the_new_metrics_are_in_benchmark_json(bench_json):
    per = {m["name"]: m for m in bench_json["per_layer"]}
    assert set(NEW) <= set(per)
    assert per["exchange_ms"]["layer"] == per["exchange_fill"]["layer"] == "exchange"
    assert per["step_plan_ms"]["layer"] == per["plan_ms"]["layer"]
    for name in NEW:
        assert per[name]["moves"] == "seeds_per_s"
        assert per[name]["source"] in ("program_span", "program_counter")
