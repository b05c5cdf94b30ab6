"""The trace reduction on a hand-made Chrome trace, and the kernel names the
roofline readers match."""
import importlib.util
import json

import pytest

from gnnbench import traces

GATHER = "void (anonymous namespace)::gather_kernel<float4, 8, 1>(float4 const*, int const*)"
TORCH_GATHER = "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*)"
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench.traced", "ts": 0, "dur": 1000},
    {"ph": "X", "cat": "kernel", "name": GATHER, "ts": 100, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": TORCH_GATHER, "ts": 150, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::spmm_fwd_kernel<float4, 8>(x)",
     "ts": 400, "dur": 50},
    {"ph": "X", "cat": "kernel", "name": "void bwd_rows_kernel<true>(float const*, int*)",
     "ts": 500, "dur": 50},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 600, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": GATHER, "ts": 2000, "dur": 100},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 250, "dur": 150},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return traces.load(str(path))


def _reader_pattern(name, attr):
    from conftest import BENCH

    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def test_busy_is_the_union_inside_the_window(trace):
    assert trace.window_s == pytest.approx(1000e-6)
    assert trace.busy_s == pytest.approx((150 + 50 + 50 + 10) * 1e-6)


def test_kernel_seconds_by_the_readers_patterns(trace):
    assert trace.kernel_s(_reader_pattern("gather_roofline", "KERNEL")) == pytest.approx(200e-6)
    assert trace.kernel_s(_reader_pattern("spmm_roofline", "KERNELS")) == pytest.approx(100e-6)


def test_breakdown(trace):
    ops = trace.device_ops()
    assert ops[0] == ["void (anonymous namespace)::gather_kernel<float4, 8, 1>", pytest.approx(200e-6)]
    gaps = trace.idle_gaps()
    assert gaps[0] == ["bench.traced", pytest.approx(390e-6)]
    assert ["cudaGraphLaunch", pytest.approx(150e-6)] in gaps
    assert len(ops) <= traces.TOP and len(gaps) <= traces.TOP


def test_short_name_drops_only_the_argument_list():
    assert traces.short_name("void ns::(anonymous namespace)::k<int>(float*)") == \
        "void ns::(anonymous namespace)::k<int>"
    assert traces.short_name("cudaGraphLaunch") == "cudaGraphLaunch"


def test_a_trace_without_the_window_is_refused(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(EVENTS[1:]))
    with pytest.raises(ValueError):
        traces.load(str(path))
