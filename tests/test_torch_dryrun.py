"""The port's LM dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), and the cost counter
(``repro_torch.launch.op_costs``).

The reference's records come from one subprocess
(``tests/dryrun_reference.py``, 512 host devices, the two outside shims);
the port traces the same combos on fake CPU tensors over a fake process
group of 256 ranks, which ``trace_combo`` starts and tears down itself.
gemma2-2b runs at its published widths with 2 layers on both sides (the
full depth takes 24 s to trace here; its numbers are in PERF.md).

Held exactly: per-device argument bytes; the dot FLOPs of the reference's
own unit programs (``tests/test_launch.py``) against ``analyze_hlo``.
Held within the tolerance stated per combo in ``FLOP_TOL``: the dot FLOPs
per device (the reference's HLO walk, not its ``flops_per_dev``, which is
the larger of that and XLA's raw cost analysis).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels import _build
from repro_torch.launch.dryrun import main, trace_combo
from repro_torch.launch.op_costs import CostCounter

ROOT = Path(__file__).resolve().parents[1]
COMBOS = {
    "gemma2-2b/train_4k": ("gemma2-2b", "train_4k", {"num_layers": 2}),
    "gemma2-2b/decode_32k": ("gemma2-2b", "decode_32k", {"num_layers": 2}),
    "whisper-tiny/train_4k": ("whisper-tiny", "train_4k", {}),
    "whisper-tiny/prefill_32k": ("whisper-tiny", "prefill_32k", {}),
}
# (lowest, highest) port / reference dot-FLOP ratio, and the products
# that make up the gap
FLOP_TOL = {
    # every product the same shape and count
    "gemma2-2b/decode_32k": (1.0, 1.0, "none"),
    # the reference splits the 2,048 query columns of wq/wo two ways over
    # the model dim (its (65536, 1024) x (1024, 2304) products), the port
    # sixteen ways (queries split by position)
    "gemma2-2b/train_4k": (0.97, 0.99, "attention projections"),
    # 6 heads on a 16-way model dim: GSPMD keeps part of the attention
    # products whole on every model rank; the port splits queries by
    # position.  The vocabulary (51,865) divides no mesh dim, so both
    # repeat the unembedding on every model rank.
    "whisper-tiny/train_4k": (0.85, 0.92, "attention scores and values"),
    "whisper-tiny/prefill_32k": (0.09, 0.11, "attention scores and values"),
}


def _reference(jobs: list) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "dryrun_reference.py"),
                          json.dumps(jobs)], capture_output=True, text=True, env=env,
                         timeout=900, check=True)
    return [json.loads(line)["record"] for line in out.stdout.splitlines()]


@pytest.fixture(scope="module")
def records() -> dict:
    jobs = [{"combo": [arch, shape, False, ov]} for arch, shape, ov in COMBOS.values()]
    ref = dict(zip(COMBOS, _reference(jobs)))
    port = {k: trace_combo(arch, shape, False, verbose=False, overrides=ov, device="cpu")
            for k, (arch, shape, ov) in COMBOS.items()}
    assert not dist.is_initialized()  # each trace tore its fake group down
    return {k: (port[k], ref[k]) for k in COMBOS}


@pytest.mark.parametrize("combo", list(COMBOS))
def test_argument_bytes_equal_reference(records, combo):
    port, ref = records[combo]
    assert port["status"] == ref["status"] == "ok"
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]


@pytest.mark.parametrize("combo", list(COMBOS))
def test_dot_flops_within_stated_tolerance(records, combo):
    port, ref = records[combo]
    lo, hi, _ = FLOP_TOL[combo]
    ratio = port["roofline"]["flops_per_dev"] / ref["hlo"]["dot_flops"]
    assert lo <= ratio <= hi, (combo, ratio)


def test_whisper_train_peak_within_reference(records):
    """whisper-tiny's vocabulary divides no mesh dim, so its logits are split
    over the batch dims only; the cross-entropy's gradient must keep that
    layout (a replicated one held the global batch's float32 logits, 25.3
    GiB a device, and put the port's peak at 30.65 GiB to the reference's
    11.78)."""
    port, ref = records["whisper-tiny/train_4k"]
    assert port["memory"]["peak_per_device_gb"] <= ref["memory"]["peak_per_device_gb"]


def test_record_keys_are_the_references(records):
    port, ref = records["gemma2-2b/decode_32k"]
    want = set(ref) - {"lower_s", "compile_s", "hlo"} | {"trace_s"}
    assert want <= set(port)
    assert set(port["memory"]) == set(ref["memory"])
    assert set(port["roofline"]) == set(ref["roofline"])
    m = port["memory"]
    assert m["temp_bytes"] >= 0 and m["alias_bytes"] <= m["output_bytes"]
    assert m["peak_per_device_gb"] * 2**30 == pytest.approx(
        m["temp_bytes"] + m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"])


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def test_unit_program_dot_flops_equal_analyze_hlo():
    """The reference's own test programs: 7 scanned 64^3 matmuls, 3
    unrolled 32^3 matmuls; the counter charges each product as it runs."""
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze_hlo

    def scanned(x, w):
        def body(h, _):
            return jnp.tanh(h @ w), None

        return jax.lax.scan(body, x, None, length=7)[0]

    def unrolled(x, w):
        for _ in range(3):
            x = x @ w
        return x

    def flops_jax(f, n):
        x = jax.ShapeDtypeStruct((n, n), jnp.float32)
        return analyze_hlo(jax.jit(f).lower(x, x).compile().as_text()).dot_flops

    with _fake():
        x, w = torch.empty(64, 64), torch.empty(64, 64)
        with CostCounter() as cc:
            h = x
            for _ in range(7):
                h = torch.tanh(h @ w)
        assert cc.costs.dot_flops == flops_jax(scanned, 64) == 7 * 2 * 64**3
        x = torch.empty(32, 32)
        with CostCounter() as cc:
            h = x
            for _ in range(3):
                h = h @ x
        assert cc.costs.dot_flops == flops_jax(unrolled, 32) == 3 * 2 * 32**3


def test_peak_counts_live_storages():
    with _fake():
        a = torch.empty(1000)  # an argument: 4,000 bytes
        with CostCounter() as cc:
            cc.add_arguments([a])
            b = a * 2             # 8,000 live
            v = b[:10]            # a view: no new storage
            del b
            c = torch.empty(2000)  # b's storage lives on in v: 4,000 + 4,000 + 8,000
            del v, c
            d = torch.empty(500)
        assert cc.costs.argument_bytes == 4000
        assert cc.costs.peak_bytes == 16000
        assert cc.live_bytes() == 6000
        del d


def test_peak_split_names_the_storages_live_at_the_peak():
    with _fake():
        a = torch.empty(1000)
        with CostCounter(split_peak=True) as cc:
            cc.add_arguments([a])
            b = a * 2
            c = torch.zeros(3000)
            del b, c
            d = torch.empty(10)
        assert cc.costs.peak_bytes == 4000 + 4000 + 12000
        assert cc.peak_split() == [
            (12000, 1, "aten.zeros.default", (3000,), "torch.float32"),
            (4000, 1, "aten.mul.Tensor", (1000,), "torch.float32"),
            (4000, 1, "argument", (1000,), "torch.float32")]
        del d


def test_launch_records_a_fake_kernel_without_calling_it(monkeypatch):
    """``_build.launch`` given fake CUDA tensors charges the counter and
    calls no library; ``LAUNCHES`` stays as it was."""
    from repro_torch.kernels.frontier_gather import frontier_gather_cuda

    def no_library(name):
        raise AssertionError(f"library {name} loaded in a trace")

    monkeypatch.setattr(_build, "library", no_library)
    before = dict(_build.LAUNCHES)
    with _fake():
        indptr = torch.empty(65, dtype=torch.int32, device="cuda")
        indices = torch.empty(640, dtype=torch.int32, device="cuda")
        seeds = torch.empty(16, dtype=torch.int32, device="cuda")
        with CostCounter() as cc:
            nbr, mask = frontier_gather_cuda(indptr, indices, seeds, 8)
        assert nbr.device.type == "cuda" and tuple(mask.shape) == (16, 8)
        assert cc.costs.kernel_launches == {"frontier_gather": 1}
        assert cc.costs.kernel_bytes == 4 * (65 + 640 + 16 + 16 * 8) + 16 * 8
        with pytest.raises(RuntimeError, match="outside a CostCounter"):
            frontier_gather_cuda(indptr, indices, seeds, 8)
    assert _build.LAUNCHES == before


def test_shard_hint_is_the_identity_without_a_mesh():
    from repro_torch.models.transformer.attention import _mesh_layout
    from repro_torch.models.transformer.modules import shard_hint

    x = torch.ones(2, 3)
    assert shard_hint(x, "batch", None) is x
    assert all(a is b for a, b in zip(_mesh_layout(x, x, x, 6, 6), (x, x, x)))


def test_cli_writes_records_and_exits_1_on_a_failed_combo(tmp_path):
    main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--device", "cpu"],
         out_dir=tmp_path)
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["memory"]["argument_bytes"] == 150_901_284
    with pytest.raises(SystemExit) as e:
        main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--device", "cpu",
              "--set", "no_such_field=1", "--tag", "bad"], out_dir=tmp_path)
    assert e.value.code == 1
    bad = json.loads((tmp_path / "whisper-tiny__decode_32k__pod16x16__bad.json").read_text())
    assert bad["status"] == "error" and "no_such_field" in bad["error"]
    assert not dist.is_initialized()
    assert np.isfinite(rec["roofline"]["memory_s"])


def test_roofline_analyze_and_collective_stats():
    """``analyze`` reads the counter's record as the reference's reads a
    compiled module: per-device terms over the H100's data-sheet rates,
    the bottleneck the largest; ``collective_stats`` groups it by op."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.op_costs import OpCosts

    costs = OpCosts(dot_flops=989e12, hbm_bytes=3.35e12 * 2, coll_bytes=450e9 * 0.5,
                    coll_detail={"all-reduce": {"bytes": 2.0e11, "count": 3.0},
                                 "all-to-all": {"bytes": 2.5e10, "count": 1.0}},
                    peak_bytes=7)
    roof = rl.analyze(costs, 256, 989e12 * 128)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == pytest.approx((1.0, 2.0, 0.5))
    assert roof.bottleneck == "memory" and roof.useful_ratio == pytest.approx(0.5)
    assert roof.peak_mem_bytes == 7.0
    assert rl.analyze(costs, 1, 0.0, dtype=torch.float32).compute_s == pytest.approx(989 / 67)
    stats = rl.collective_stats(costs)
    assert stats.total_bytes == pytest.approx(2.25e11)
    assert stats.count_by_op == {"all-reduce": 3.0, "all-to-all": 1.0}


def test_host_and_production_meshes_on_a_fake_group():
    from repro_torch.launch.mesh import (
        batch_axes, fake_process_group, make_host_mesh, make_production_mesh)

    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model") and tuple(mesh.shape) == (2, 16, 16)
        assert batch_axes(mesh) == ("pod", "data")
        assert tuple(make_host_mesh(device_type="cpu").shape) == (512,)
        with pytest.raises(RuntimeError, match="already running"):
            with fake_process_group(4):
                pass
    assert not dist.is_initialized()
