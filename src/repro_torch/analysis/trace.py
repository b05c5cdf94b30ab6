"""Trace-hygiene pass: shape drift and host syncs (port of
``repro.analysis.trace``).

Runs the port's counterparts of the JAX package's ``jax.jit`` entry
points (the ``gather``, ``spmm`` and ``seg_softmax`` kernel wrappers, CSR
neighbor lookup, the engine's plan build and ``plan_at``, and the
serving step) on tiny synthetic inputs, with call variants that MUST
share one program (fresh same-shape inputs, successive schedule steps).
A ``TorchDispatchMode`` records every ATen op each call dispatches, with
its output shapes, on the CPU and on the card alike, and the pass
reports:

* RA201 shape-drift -- two variants dispatched different op/shape
  sequences.  Eager PyTorch never retraces, so this is the analogue of a
  silent recompilation: a captured CUDA graph per bucket would not
  survive it;
* RA202 host-syncs -- a call read a device scalar on the host
  (``aten._local_scalar_dense``), ran an op whose output shape depends on
  values (``nonzero``, ``unique``, ``masked_select``, boolean indexing,
  ``repeat_interleave`` without ``output_size``) or copied device->host.
  On a card each call also runs under
  ``torch.cuda.set_sync_debug_mode("warn")``, whose warnings are counted
  beside the dispatch count;
* RA299 harness-failure -- the entry point could not be exercised;
* RA200 -- the entry is clean.

Inputs are made before the counted calls (as the reference makes them
before ``jax.transfer_guard``), and the first variant runs once
unrecorded first, as the reference's first call compiles outside the
guard: lazily built state (the seed-pool table, a kernel library) is not
a drift.  The reference's RA203 (an unhashable static argument to
``jax.jit``) has no counterpart: nothing here is jitted.
"""
from __future__ import annotations

import os
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding, Severity

#: ops whose output shape depends on the input's values: the host must
#: wait for the device to size the output
VALUE_SHAPED_OPS = frozenset({
    "aten.nonzero.default", "aten.argwhere.default", "aten.masked_select.default",
    "aten._unique.default", "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default", "aten.unique_dim_consecutive.default",
})
_BOOL_INDEXED_OPS = frozenset({
    "aten.index.Tensor", "aten.index_put.default", "aten.index_put_.default",
    "aten._index_put_impl_.default",
})


@dataclass
class CallRecord:
    """What one call dispatched."""

    ops: list = field(default_factory=list)   # [(op, output (shape, dtype)s)]
    scalar_reads: int = 0                      # aten._local_scalar_dense
    value_shaped: int = 0                      # output shape depends on values
    d2h_copies: int = 0                        # device -> host copies
    sync_warnings: Optional[int] = None        # set_sync_debug_mode, card only
    sites: dict = field(default_factory=dict)  # "sync @ file:line" -> count

    @property
    def syncs(self) -> int:
        return self.scalar_reads + self.value_shaped + self.d2h_copies

    def signature(self) -> tuple:
        return tuple(self.ops)

    def to_dict(self) -> dict:
        return {
            "ops": len(self.ops), "syncs": self.syncs,
            "scalar_reads": self.scalar_reads, "value_shaped": self.value_shaped,
            "d2h_copies": self.d2h_copies, "sync_warnings": self.sync_warnings,
            "sites": dict(sorted(self.sites.items())),
        }


_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
#: The text of the warning ``set_sync_debug_mode("warn")`` gives for each
#: synchronizing CUDA call (the mode's one-time "Synchronization debug mode
#: is a prototype feature" notice is no sync).
SYNC_WARNING = "called a synchronizing CUDA operation"
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep


def _short(path: str) -> str:
    norm = os.path.abspath(path).replace(os.sep, "/")
    cut = norm.rfind("/repro_torch/")
    return norm[cut + 1:] if cut >= 0 else os.path.basename(norm)


def _caller() -> str:
    """``file:line`` of the innermost Python frame outside torch and this
    package that led to the current op (paths from ``repro_torch/`` on)."""
    for fr in reversed(traceback.extract_stack()):
        if not os.path.abspath(fr.filename).startswith((_TORCH_DIR, _ANALYSIS_DIR)):
            return f"{_short(fr.filename)}:{fr.lineno}"
    return "<unknown>"


def _on(t, kind: str) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == kind


class _OpRecorder(TorchDispatchMode):
    """Records every op; on a card a scalar read or value-shaped op counts
    only when it reads a CUDA tensor (one on a host tensor waits for
    nothing), on the CPU every one counts, as it would sync on a card."""

    def __init__(self, record: CallRecord, device_type: str):
        super().__init__()
        self.record = record
        self.card = device_type == "cuda"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec, name = self.record, str(func)
        shapes = tuple(
            (tuple(t.shape), t.dtype) for t in tree_leaves(out)
            if isinstance(t, torch.Tensor)
        )
        rec.ops.append((name, shapes))
        sync = None
        if self.card and not any(_on(t, "cuda") for t in tree_leaves(args)):
            pass
        elif name == "aten._local_scalar_dense.default":
            rec.scalar_reads += 1
            sync = name
        elif name in VALUE_SHAPED_OPS or (
            name == "aten.repeat_interleave.Tensor"
            and kwargs.get("output_size") is None
        ) or (
            name in _BOOL_INDEXED_OPS and len(args) > 1 and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1] or ()
            )
        ):
            rec.value_shaped += 1
            sync = name
        elif name in ("aten._to_copy.default", "aten.copy_.default"):
            src, dst = (args[0], out) if name == "aten._to_copy.default" else (args[1], args[0])
            if _on(src, "cuda") and _on(dst, "cpu"):
                rec.d2h_copies += 1
                sync = "device->host copy"
        if sync is not None:
            site = f"{sync} @ {_caller()}"
            rec.sites[site] = rec.sites.get(site, 0) + 1
        return out


def record_call(device: torch.device, fn: Callable, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), CallRecord)``: every ATen op the call
    dispatched and its host syncs; on a card (``device`` CUDA) also the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")`` during the
    call, which then ends in a device sync."""
    rec = CallRecord()
    if device.type != "cuda":
        with _OpRecorder(rec, device.type):
            out = fn(*args, **kwargs)
        return out, rec
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with _OpRecorder(rec, device.type):
                out = fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    warned = [w for w in caught if SYNC_WARNING in str(w.message)]
    rec.sync_warnings = len(warned)
    for w in warned:
        site = f"sync-debug warning @ {_short(w.filename)}:{w.lineno}"
        rec.sites[site] = rec.sites.get(site, 0) + 1
    torch.cuda.synchronize()
    return out, rec


@dataclass
class TraceEntry:
    """One entry point plus call variants that must share one program."""

    name: str
    anchor: str                     # file anchor for findings
    build: Callable                 # (device) -> (fn, [() -> (args, kwargs)])


def _kernel_entries() -> List[TraceEntry]:
    def gather(device):
        from repro_torch.kernels import gather

        t0 = torch.zeros((16, 128), device=device)
        t1 = torch.ones((16, 128), device=device)
        i0 = torch.zeros((8,), dtype=torch.int32, device=device)
        i1 = torch.arange(8, dtype=torch.int32, device=device)
        return gather, [
            lambda: ((t0, i0), {}),
            lambda: ((t1, i1), {}),
        ]

    def spmm(device):
        from repro_torch.kernels import spmm_mean

        s0 = torch.zeros((16, 128), device=device)
        s1 = torch.ones((16, 128), device=device)
        ix = torch.zeros((8, 4), dtype=torch.int32, device=device)
        mk = torch.ones((8, 4), dtype=torch.bool, device=device)
        return spmm_mean, [
            lambda: ((s0, ix, mk), {}),
            lambda: ((s1, ix, mk), {}),
        ]

    def seg(device):
        from repro_torch.kernels import seg_softmax

        e0 = torch.zeros((8, 4), device=device)
        e1 = torch.ones((8, 4), device=device)
        mk = torch.ones((8, 4), dtype=torch.bool, device=device)
        return seg_softmax, [
            lambda: ((e0, mk), {}),
            lambda: ((e1, mk), {}),
        ]

    return [
        TraceEntry("kernels.gather", "src/repro_torch/kernels/gather/ops.py", gather),
        TraceEntry("kernels.spmm", "src/repro_torch/kernels/spmm/ops.py", spmm),
        TraceEntry("kernels.seg_softmax", "src/repro_torch/kernels/seg_softmax/ops.py", seg),
    ]


def _tiny_graph(device):
    import numpy as np

    from repro_torch.core.graph import Graph

    rng = np.random.default_rng(0)
    V, E = 64, 256
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    return Graph.from_edges(src, dst, num_vertices=V, max_degree=8, device=device)


def _graph_entry() -> TraceEntry:
    def build(device):
        g = _tiny_graph(device)
        s0 = torch.arange(8, dtype=torch.int32, device=device)
        s1 = torch.arange(8, 16, dtype=torch.int32, device=device)
        return g.neighbor_table, [
            lambda: ((s0,), {}),
            lambda: ((s1,), {}),
        ]

    return TraceEntry(
        "graph.neighbor_table", "src/repro_torch/core/graph.py", build
    )


def _engine_entry() -> TraceEntry:
    def build(device):
        from repro_torch.engine import EngineConfig, MinibatchEngine

        g = _tiny_graph(device)
        engine = MinibatchEngine.from_config(
            g,
            EngineConfig(
                mode="independent", num_pes=1, local_batch=8, num_layers=2,
                sampler="labor0", fanout=4, schedule="smoothed", kappa=4,
            ),
            device=device,
        )

        def fn(seeds, step):
            # the engine's contract: one program serves the whole kappa
            # schedule, whatever the step
            return engine.build_plan(seeds, rng=engine.rng_state(step))

        s0 = torch.arange(8, dtype=torch.int32, device=device)
        s1 = torch.arange(8, 16, dtype=torch.int32, device=device)
        return fn, [
            lambda: ((s0, 0), {}),
            lambda: ((s1, 1), {}),
            lambda: ((s0, 7), {}),  # crosses the kappa window
        ]

    return TraceEntry(
        "engine.build_plan[smoothed]", "src/repro_torch/engine/engine.py", build
    )


def _plan_at_entry() -> TraceEntry:
    def build(device):
        from repro_torch.engine import EngineConfig, MinibatchEngine

        g = _tiny_graph(device)
        engine = MinibatchEngine.from_config(
            g,
            EngineConfig(
                mode="independent", num_pes=2, local_batch=8, num_layers=2,
                sampler="labor0", fanout=4, schedule="nested", kappa=4,
                plan_backend="fused",
            ),
            device=device,
        )
        # the seed draw + plan build must serve every step, including the
        # within-group sub-batch slice
        return engine.plan_at, [
            lambda: ((0,), {}),
            lambda: ((1,), {}),
            lambda: ((7,), {}),  # crosses into the next group
        ]

    return TraceEntry(
        "engine.plan_at[nested]", "src/repro_torch/engine/engine.py", build
    )


def _serve_entry() -> TraceEntry:
    def build(device):
        from repro_torch.data import make_recsys
        from repro_torch.models.gnn import GNNConfig, init_gnn
        from repro_torch.serve import GNNServer, ServeConfig

        ds = make_recsys(
            num_users=64, num_items=32, edges_per_user=4, feature_dim=32,
            seed=0, device=device,
        )
        gnn = GNNConfig(
            model="gcn", num_layers=2, in_dim=32, hidden_dim=32,
            num_classes=ds.num_classes,
        )
        server = GNNServer(
            ds.graph, ds.features, gnn, init_gnn(gnn, seed=0, device=device),
            ServeConfig(num_layers=2, fanout=4, max_batch=8, min_bucket=8,
                        use_cache=False),
            device=device,
        )
        # the serving contract: every same-bucket coalesced batch --
        # whichever seeds traffic merged -- runs ONE op sequence
        s0 = torch.as_tensor(ds.user_ids[:8], dtype=torch.int32).to(device)
        s1 = torch.as_tensor(ds.user_ids[8:16], dtype=torch.int32).to(device)
        return server.hot_path, [
            lambda: ((s0,), {}),
            lambda: ((s1,), {}),
        ]

    return TraceEntry(
        "serve.hot_path[bucket=8]", "src/repro_torch/serve/server.py", build
    )


def default_entries() -> List[TraceEntry]:
    return _kernel_entries() + [
        _graph_entry(), _engine_entry(), _plan_at_entry(), _serve_entry(),
    ]


def _first_drift(a: tuple, b: tuple) -> int:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def run_trace(device: torch.device, entries: Iterable[TraceEntry] = None) -> List[Finding]:
    findings: List[Finding] = []
    for entry in entries if entries is not None else default_entries():
        try:
            fn, scenarios = entry.build(device)
            # every scenario's inputs exist before any counted call
            calls = [make() for make in scenarios]
            args, kwargs = calls[0]
            fn(*args, **kwargs)  # warm-up: lazily built state, kernel loads
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            records = [record_call(device, fn, *a, **k)[1] for a, k in calls]
        except Exception as e:
            findings.append(Finding(
                rule="RA299", severity=Severity.ERROR,
                message=f"trace harness for `{entry.name}` raised: {e!r}",
                file=entry.anchor,
            ))
            continue

        calls_extra = [r.to_dict() for r in records]
        sigs = [r.signature() for r in records]
        same = all(s == sigs[0] for s in sigs[1:])
        extra = dict(entry=entry.name, device=device.type, calls=calls_extra,
                     same_signature=same)
        clean = True
        if not same:
            clean = False
            bad = next(i for i, s in enumerate(sigs) if s != sigs[0])
            at = _first_drift(sigs[0], sigs[bad])
            first = sigs[0][at] if at < len(sigs[0]) else None
            other = sigs[bad][at] if at < len(sigs[bad]) else None
            findings.append(Finding(
                rule="RA201", severity=Severity.ERROR,
                message=f"`{entry.name}` drifted: call {bad} dispatched "
                        f"{len(sigs[bad])} ops against call 0's {len(sigs[0])}, "
                        f"first differing at op {at} ({first} vs {other}) -- "
                        f"{len(scenarios)} calls that must share one program",
                file=entry.anchor,
                extra=dict(extra, drift_op=at),
            ))
        if any(r.syncs or r.sync_warnings for r in records):
            clean = False
            counts = ", ".join(
                f"{r.syncs}" + ("" if r.sync_warnings is None else f"/{r.sync_warnings}")
                for r in records
            )
            findings.append(Finding(
                rule="RA202", severity=Severity.ERROR,
                message=f"`{entry.name}`: host syncs per call {counts} "
                        "(dispatched" + ("/sync-debug warnings" if device.type == "cuda"
                                          else "") + ") while executing the step",
                file=entry.anchor,
                extra=extra,
            ))
        if clean:
            findings.append(Finding(
                rule="RA200", severity=Severity.INFO,
                message=f"`{entry.name}`: one op sequence across "
                        f"{len(scenarios)} calls, no host syncs",
                file=entry.anchor,
                extra=extra,
            ))
    return findings
