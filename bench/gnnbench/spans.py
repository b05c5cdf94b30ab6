"""Readings of the program's own spans in a traced window (:mod:`gnnbench.traces`).

The port marks the stages of its train step from inside the captured
graph (``repro_torch.utils.spans``): each end of a span is one launch of a
marker kernel named after the span (``exchange.fwd.l2`` ->
``span_exchange_fwd_l2``), so on the device timeline the markers of one
name alternate begin and end.  A span's device time is the time from the
end of its begin marker to the start of its end marker.  The host side
has ``record_function`` ranges that the program enters only under a
profiler: ``engine.step_state`` (the step state's pinned upload) and
``<program>.replay`` (a replay's input copies, graph launch and output
clones).

Every function here gives an empty or ``None`` reading where the trace
has none of these (a program without spans, or a CPU trace).
"""
from __future__ import annotations

import re

from gnnbench import traces

MARKER = re.compile(r"(?:^|[\s:])span_(\w+?)(?:\(|$)")
STEP_STATE = "engine.step_state"
REPLAY = ".replay"
# runtime calls that block the host until the device (or a copy) is done
BLOCKING = re.compile(r"^(cudaDeviceSynchronize|cudaStreamSynchronize|cudaEventSynchronize"
                      r"|cudaHostAlloc|cudaFreeHost|cudaMemcpy(?!\w*Async)\w*)$")


def _inside(tr: traces.Trace, events: list) -> list:
    lo, hi = tr.window
    return [ev for ev in events if ev[1] > lo and ev[0] < hi]


def markers(tr: traces.Trace) -> dict:
    """``{span: [(begin_end, end_start)]}`` of the marker pairs inside the
    window, the span named as its kernel is (``exchange_fwd_l2``)."""
    by_name: dict = {}
    for s, e, name in sorted(_inside(tr, tr.device)):
        m = MARKER.search(name)
        if m:
            by_name.setdefault(m.group(1), []).append((s, e))
    return {name: [(b[1], e[0]) for b, e in zip(evs[0::2], evs[1::2])]
            for name, evs in by_name.items() if len(evs) >= 2}


def span_ms(tr: traces.Trace, pattern: str, steps: int):
    """Device ms a step inside the marker pairs of the spans whose kernel
    name matches ``pattern``; ``None`` without such markers."""
    rx = re.compile(pattern)
    pairs = [p for name, ps in markers(tr).items() if rx.fullmatch(name) for p in ps]
    if not pairs or steps <= 0:
        return None
    return sum(e - b for b, e in pairs) * 1e-3 / steps


def host_spans(tr: traces.Trace, keep) -> list:
    """``(start, end)`` of the host events inside the window whose name
    ``keep(name)`` accepts."""
    return [(s, e) for s, e, name in _inside(tr, tr.host) if keep(name)]


def idle_gaps(tr: traces.Trace) -> list:
    """``(start, end)`` of the intervals of the window in which no kernel,
    copy or memset ran."""
    lo, hi = tr.window
    edges = [lo] + [x for s, e in tr._busy_intervals() for x in (s, e)] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def overlap_us(a: list, b: list) -> float:
    """Microseconds in which an interval of ``a`` and one of ``b`` overlap
    (the intervals of ``b`` are merged first)."""
    merged = []
    for s, e in sorted(b):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(max(0.0, min(e, me) - max(s, ms)) for s, e in a for ms, me in merged)


def blocking_calls(tr: traces.Trace, spans: list) -> int:
    """Blocking runtime calls (:data:`BLOCKING`) that begin inside one of ``spans``."""
    return sum(1 for s, _, name in _inside(tr, tr.host)
               if BLOCKING.match(name) and any(a <= s <= b for a, b in spans))


def kernels_by_span(tr: traces.Trace) -> dict:
    """``{span: {kernel: device s}}``: every device event of the window put
    down to the innermost marker pair it falls in (``None``: in none)."""
    pairs = sorted(((b, e, name) for name, ps in markers(tr).items() for b, e in ps),
                   key=lambda p: p[1] - p[0])
    out: dict = {}
    for s, e, name in _inside(tr, tr.device):
        if MARKER.search(name):
            continue
        mid = 0.5 * (s + e)
        span = next((n for b, end, n in pairs if b <= mid <= end), None)
        k = traces.short_name(name)
        out.setdefault(span, {})
        out[span][k] = out[span].get(k, 0.0) + (e - s) * 1e-6
    return out
