"""Spans and counters inside the port's programs: its one tracing system.

The hot path is one captured CUDA graph a step, and a replayed graph
shows kernels but not which stage launched them.  So the stages mark
themselves from inside the program:

* :func:`span` ``(name)`` launches a marker kernel at its start and at its
  end (:mod:`repro_torch.kernels.span_marker`).  The marker reads the
  device's global timer and adds the span's time into a small device
  accumulator (total ns, count, last start).  Launched while a graph is
  captured, the markers are kernel nodes of the graph and run on every
  replay, with no host work; on a profiler's device timeline each is an
  event named after its span (``exchange.fwd.l2`` ->
  ``span_exchange_fwd_l2``), on the same clock as every other kernel.  On
  the CPU the same call stamps ``time.perf_counter_ns``.
* :func:`count` ``(name, value)`` adds a device integer (or a python int)
  into a counter of the same buffer, in the graph too.
* :func:`mark_backward` places the two ends of a span on the backward of a
  differentiable region: its gradients pass through identity functions
  whose backwards stamp the span.
* :func:`host_span` is a ``record_function`` range on the host, entered
  only while a profiler runs, so it costs nothing otherwise.

Spans and counters go to the :class:`SpanRecorder` that a program makes
active around its body (``CompiledFunction(..., spans=True)``); outside
one they do nothing.  Its buffer is allocated before the program's first
call, outside any graph's memory pool, and read on the host only by
:meth:`SpanRecorder.totals` and :meth:`SpanRecorder.drain` (one copy,
outside any timed region).  A span's parent is the span open when it
first began; its self time is its time less its children's.

The names are fixed (:data:`SPANS`, :data:`COUNTERS`): each span has a
marker kernel of its own, and the kernel list in ``span_marker.cu``
follows :data:`SPANS` in order.  A layer's name (``...l{l}``) past
:data:`MAX_LAYERS` records nothing, so a deeper model trains without the
spans and counters of its layers from there on.
"""
from __future__ import annotations

import re
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Callable, Iterator, Optional, Union

import torch
import torch.autograd.profiler as _profiler

from repro_torch.kernels.span_marker import span_marker

MAX_LAYERS = 8  # exchange spans and counters exist for layers 0 .. MAX_LAYERS - 1
SPANS = ("plan", "gather", "forward", "backward", "all_reduce", "adam",
         *(f"exchange.{kind}.l{l}" for kind in ("ids", "fwd", "bwd")
           for l in range(MAX_LAYERS)))
COUNTERS = ("replays", "input_rows",
            *(f"exchange.{what}.l{l}" for what in ("id_bytes", "valid_bytes", "slot_bytes")
              for l in range(MAX_LAYERS)))
_SPAN = {name: i for i, name in enumerate(SPANS)}
_COUNTER = {name: 3 * len(SPANS) + i for i, name in enumerate(COUNTERS)}

_LAYER = re.compile(r"\.l(\d+)$")

_active: ContextVar[Optional["SpanRecorder"]] = ContextVar("repro_torch_spans", default=None)


class SpanRecorder:
    """The accumulators of one program's spans and counters, on ``device``."""

    def __init__(self, device: Union[torch.device, str]):
        self.buf = torch.zeros(3 * len(SPANS) + len(COUNTERS), dtype=torch.int64,
                               device=device)
        self.parents: dict[str, Optional[str]] = {}  # spans in the order first begun
        self.counted: dict[str, None] = {}           # counters in the order first added
        self._open: list[str] = []
        self._drained: Optional[torch.Tensor] = None

    @contextmanager
    def active(self) -> Iterator["SpanRecorder"]:
        """Makes this recorder the one :func:`span` and :func:`count` write to."""
        token = _active.set(self)
        try:
            yield self
        finally:
            _active.reset(token)

    def mark(self, name: str, end: bool) -> None:
        """Begins or ends span ``name`` (one marker launch)."""
        if name not in _SPAN:
            raise ValueError(f"no span named {name!r}; the spans are SPANS")
        if end:
            if not self._open or self._open[-1] != name:
                raise RuntimeError(f"span {name!r} ends while {self._open} are open")
            self._open.pop()
        else:
            self.parents.setdefault(name, self._open[-1] if self._open else None)
            self._open.append(name)
        span_marker(self.buf, _SPAN[name], end, len(SPANS))

    def count(self, name: str, value: Union[int, torch.Tensor]) -> None:
        """Adds ``value`` (a python int or a 0-d integer tensor) to counter ``name``."""
        if name not in _COUNTER:
            raise ValueError(f"no counter named {name!r}; the counters are COUNTERS")
        self.counted.setdefault(name, None)
        i = _COUNTER[name]
        self.buf[i: i + 1].add_(value)

    def totals(self) -> dict:
        """Everything recorded so far: ``{"spans": {name: {count, ms,
        self_ms, parent}}, "counters": {name: value}, "replays": n}``
        (``replays``: the program's runs)."""
        return self._summary(self.buf.to("cpu", copy=True))

    def drain(self) -> dict:
        """What :meth:`totals` gives, as the change since the last drain."""
        host = self.buf.to("cpu", copy=True)
        delta = host if self._drained is None else host - self._drained
        self._drained = host
        return self._summary(delta)

    def _summary(self, host: torch.Tensor) -> dict:
        vals = host.tolist()
        spans = {name: {"count": vals[3 * _SPAN[name] + 1], "ms": vals[3 * _SPAN[name]] / 1e6,
                        "parent": parent}
                 for name, parent in self.parents.items()}
        for name, s in spans.items():
            s["self_ms"] = s["ms"] - sum(c["ms"] for c in spans.values() if c["parent"] == name)
        counters = {name: vals[_COUNTER[name]] for name in self.counted}
        return {"spans": spans, "counters": counters, "replays": counters.get("replays", 0)}


def _recorder(name: str) -> Optional[SpanRecorder]:
    """The active recorder, or None where there is none or ``name`` is a
    layer's past :data:`MAX_LAYERS`."""
    rec = _active.get()
    layer = _LAYER.search(name)
    if rec is None or (layer is not None and int(layer.group(1)) >= MAX_LAYERS):
        return None
    return rec


@contextmanager
def span(name: str) -> Iterator[None]:
    """Marks the work inside the block as span ``name`` of the active
    recorder (nothing without one)."""
    rec = _recorder(name)
    if rec is None:
        yield
        return
    rec.mark(name, False)
    try:
        yield
    finally:
        rec.mark(name, True)


def count(name: str, value: Union[int, torch.Tensor, Callable]) -> None:
    """Adds ``value`` to counter ``name`` of the active recorder (nothing
    without one).  ``value`` may be a function that gives it, called only
    under a recorder, so a program without spans computes nothing."""
    rec = _recorder(name)
    if rec is not None:
        rec.count(name, value() if callable(value) else value)


class _BackwardMark(torch.autograd.Function):
    """Identity whose backward stamps one end of a span."""

    @staticmethod
    def forward(ctx, x, rec, name, end):
        ctx.rec, ctx.name, ctx.end = rec, name, end
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rec.mark(ctx.name, ctx.end)
        return g, None, None, None


def mark_backward(x: torch.Tensor, name: str, end: bool) -> torch.Tensor:
    """``x``, through an identity whose backward begins (at a region's
    output, ``end`` False) or ends (at its input, ``end`` True) span
    ``name`` of the active recorder.  ``x`` itself where there is no
    recorder or ``x`` needs no gradient."""
    rec = _recorder(name)
    if rec is None or not x.requires_grad:
        return x
    return _BackwardMark.apply(x, rec, name, end)


def host_span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs; a
    context that does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return nullcontext()
