"""Keyed device programs: the port's counterpart of ``jax.jit`` as the JAX
package uses it (``MinibatchEngine.plan_at``, ``ShardRunner``'s build,
the train steps, ``BucketedJit`` in serving).

A :class:`CompiledFunction` wraps a function of tensors.  Each call names
a key (a serving bucket, or the one shape of ``plan_at``); the first call
of a key fixes its shape signature, and a call with another signature
raises :class:`RetraceError`, as a second trace of a bucket does in the
JAX package.  ``compiles[key]`` counts the signatures a key has seen.

With ``capture=True`` (a CUDA device) the first call of a key runs the
function eagerly on a side stream -- the warm-up, whose result is that
call's result -- and then records it into a ``torch.cuda.CUDAGraph``
whose inputs are static buffers.  Every later call copies its inputs into
those buffers, replays the graph and returns clones of the graph's
outputs, so two results never share memory (as JAX's results do not).
A capture that fails raises :class:`CaptureError`; nothing falls back to
eager.

Arguments named in ``state_args`` are the program's state: their tensors
are read and written in place by the graph (a decode step's caches, a
cache's tags and rows), so they are neither cloned nor copied.  A
program is recorded for each key and set of state addresses: a call with
another state of the same shapes records one more program (its first
call again the eager warm-up), and a call whose state sits at the
addresses of an earlier one replays that one, which then reads and
writes the caller's tensors.

The Python collector is run before and paused during a capture: a dead
graph of another program, destroyed mid-capture, would break it.  The
kernels a graph launches are recorded at capture (the wrappers' counts
are restored, since capture launches nothing) and added to
:data:`repro_torch.kernels.LAUNCHES` on every replay.

With ``spans=True`` each key has a
:class:`repro_torch.utils.spans.SpanRecorder`, allocated at the key's
first call (before any capture, outside the graph's pool) and active
around every run of the body: the eager call, the warm-up and the
capture, so the body's spans and counters (and a ``replays`` counter
added once a run) are kernel nodes of the graph.  :meth:`report` adds
their totals, and :meth:`CompiledFunction.spans` drains them.  A replay
is the host span ``{name}.replay`` while a profiler runs.

Eager is chosen by the caller's configuration only: the CPU, the
reference plan backend (its ``torch.unique`` dedup has a data-dependent
shape), the shard executor over gloo (its collectives run on the host;
NCCL's are kernels, recorded like any other) and an LM step under a
registered mesh (the dry-run's fake tensors) run the function as it is,
under the same signature check.  The graphs of one engine or
server may share a memory pool: they replay one at a time on one stream,
and each replay's outputs are cloned before the next one runs.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels._build import LAUNCHES
from repro_torch.utils.spans import SpanRecorder, host_span


class RetraceError(RuntimeError):
    """A key of a compiled function saw a second shape signature -- a
    shape hygiene bug that its captured program would not survive (the
    JAX package raises it on a second trace of a bucket)."""


class CaptureError(RuntimeError):
    """Recording a function into a CUDA graph failed."""


def tree_map(fn: Callable, x):
    """``fn`` on every tensor leaf of ``x`` (tensors, dataclasses such as
    plans, named tuples, tuples, lists, dicts and ``None``); other leaves
    stay as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return type(x)((k, tree_map(fn, v)) for k, v in x.items())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: tree_map(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a named tuple
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def tensor_leaves(*objs) -> list:
    """The tensor leaves of ``objs``, in :func:`tree_map`'s order."""
    out = []
    for obj in objs:
        tree_map(out.append, obj)
    return out


def shape_signature(*objs) -> tuple:
    """``(shape, dtype)`` of every tensor leaf of ``objs``, in order."""
    return tuple((tuple(t.shape), t.dtype) for t in tensor_leaves(*objs))


@dataclasses.dataclass
class _Program:
    """One captured graph: static inputs, static outputs, and the kernel
    launches a replay makes."""

    graph: Any
    inputs: list
    outputs: Any
    launches: dict
    capture_ms: float
    pool_bytes: int

    def replay(self, args: tuple):
        for dst, src in zip(self.inputs, tensor_leaves(args)):
            if dst is not None and dst.data_ptr() != src.data_ptr():
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] = LAUNCHES.get(name, 0) + n
        return tree_map(torch.clone, self.outputs)


class CompiledFunction:
    """``fn`` as one program per key (see the module docstring).

    ``capture`` records a CUDA graph per key (the arguments must then be
    CUDA tensors); ``pool`` is a ``torch.cuda.graph_pool_handle()`` to
    share with other programs that never replay at once (default: one
    pool of this function's own).  ``state_args`` are the positions of
    the arguments passed by reference (see the module docstring).
    ``captures[key]`` counts the graphs recorded for a key.  ``spans``
    records the body's spans and counters (see the module docstring).
    """

    def __init__(self, name: str, fn: Optional[Callable] = None, capture: bool = False,
                 pool=None, state_args: tuple = (), spans: bool = False):
        self.name = name
        self.fn = fn
        self.capture = capture
        self.state_args = tuple(state_args)
        self.records_spans = spans
        self.compiles: dict = {}
        self.captures: dict = {}
        self._signatures: dict = {}
        self._programs: dict = {}
        self._recorders: dict = {}
        self._pool = pool
        self._stream = None

    # -- the signature guard ----------------------------------------------
    def check(self, key, *args) -> None:
        """Record the shape signature of one call of ``key``; a second
        signature raises :class:`RetraceError`."""
        seen = self._signatures.setdefault(key, set())
        sig = shape_signature(*args)
        if sig in seen:
            return
        seen.add(sig)
        self.compiles[key] = len(seen)
        if len(seen) > 1:
            raise RetraceError(
                f"{self.name}: bucket {key} saw {len(seen)} shape signatures "
                "-- the step must keep one program per bucket"
            )

    def assert_compiled_once_per_bucket(self) -> None:
        bad = {k: n for k, n in self.compiles.items() if n > 1}
        if bad:
            raise RetraceError(f"{self.name}: retraced buckets {bad}")

    # -- calls ----------------------------------------------------------------
    def __call__(self, key, *args):
        self.check(key, *args)
        rec = None
        if self.records_spans:
            rec = self._recorders.get(key)
            if rec is None:
                rec = self._recorders[key] = SpanRecorder(tensor_leaves(args)[0].device)
        if not self.capture:
            return self._run(rec, args)
        state = tuple(t.data_ptr() for i in self.state_args for t in tensor_leaves(args[i]))
        progs = self._programs.setdefault(key, {})
        prog = progs.get(state)
        if prog is None:
            out, progs[state] = self._compile(key, args, rec)
            self.captures[key] = self.captures.get(key, 0) + 1
            return out
        with host_span(f"{self.name}.replay"):
            return prog.replay(args)

    def _run(self, rec: Optional[SpanRecorder], args: tuple):
        """The body on ``args``, with ``rec`` active and counting the run."""
        if rec is None:
            return self.fn(*args)
        with rec.active():
            rec.count("replays", 1)
            return self.fn(*args)

    def program(self, key) -> Optional[_Program]:
        """The captured program of ``key`` last recorded (None before its
        first call or when running eagerly)."""
        progs = self._programs.get(key)
        return next(reversed(progs.values())) if progs else None

    def _compile(self, key, args: tuple, rec: Optional[SpanRecorder]):
        """Warm-up call on a side stream (the call's result), then capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
        cur, side = torch.cuda.current_stream(), self._stream
        # state arguments keep their tensors (None: nothing to copy in)
        inputs = [None if i in self.state_args else t.clone()
                  for i, a in enumerate(args) for t in tensor_leaves(a)]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run(rec, args)
        static_args = _rebuild(args, [t if t is not None else s for t, s in
                                      zip(inputs, tensor_leaves(args))])
        before = dict(LAUNCHES)
        # dead graphs of other programs (in reference cycles) must go now:
        # a graph destroyed by the collector during the capture breaks it
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as the capture's own start does
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                outputs = self._run(rec, static_args)
        except Exception as e:
            raise CaptureError(f"{self.name}: capturing bucket {key} failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
            launches = {k: n - before.get(k, 0) for k, n in LAUNCHES.items()
                        if n != before.get(k, 0)}
            LAUNCHES.clear()
            LAUNCHES.update(before)
        torch.cuda.synchronize()
        prog = _Program(graph, inputs, outputs, launches,
                        1e3 * (time.perf_counter() - t0),
                        torch.cuda.memory_reserved() - reserved)
        cur.wait_stream(side)
        tree_map(lambda t: t.record_stream(cur), out)
        return out, prog

    def report(self) -> dict:
        """Per captured key, of its first program (the one that grew the
        pool; a later state's reuses it): capture ms, pool bytes grown by
        the capture and the kernel launches a replay adds; and the key's
        count of programs (one per state).  With ``spans``, also the key's
        span and counter totals over all its runs (``spans``, ``counters``
        and ``replays``, :meth:`SpanRecorder.totals`: one copy to the host
        a key)."""
        return {k: {"capture_ms": p.capture_ms, "pool_bytes": p.pool_bytes,
                    "launches": dict(p.launches), "programs": len(progs),
                    **(self._recorders[k].totals() if k in self._recorders else {})}
                for k, progs in self._programs.items() for p in [next(iter(progs.values()))]}

    def spans(self) -> dict:
        """Per key that recorded spans, eager or captured: its spans and
        counters since the last call (:meth:`SpanRecorder.drain`)."""
        return {k: rec.drain() for k, rec in self._recorders.items()}


def _rebuild(args: tuple, leaves: list):
    """``args`` with its tensor leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), args)
