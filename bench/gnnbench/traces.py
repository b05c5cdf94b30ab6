"""Reduction of a ``torch.profiler`` trace (its Chrome trace JSON) to what
the per-layer metrics read: device time by kernel name, the union of the
device's busy intervals inside the traced window, and the longest idle
gaps with what the host was doing meanwhile."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "bench.traced"  # the harness's annotation around the traced steps
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 200
    characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:200]


@dataclass
class Trace:
    """Device and host intervals (microseconds) of one traced window."""

    window: tuple                                # (start, end) of WINDOW
    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _busy_intervals(self) -> list:
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for s, e, _ in self.device if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) * 1e-6

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the device events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, n in self.device if rx.search(n)) * 1e-6

    def device_ops(self) -> list:
        """The ``TOP`` device operations by total seconds: ``[[name, s]]``."""
        total: dict = {}
        for s, e, n in self.device:
            k = short_name(n)
            total[k] = total.get(k, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """The ``TOP`` longest idle gaps of the device inside the window,
        each named by the innermost host event around its middle."""
        lo, hi = self.window
        busy = self._busy_intervals()
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
            mid = 0.5 * (s + e)
            around = [h for h in self.host if h[0] <= mid <= h[1]]
            name = min(around, key=lambda h: h[1] - h[0])[2] if around else "host idle"
            out.append([short_name(name), (e - s) * 1e-6])
        return out


def load(path: str) -> Trace:
    """A :class:`Trace` from a Chrome trace that ``export_chrome_trace`` wrote."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    window, device, host = None, [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        span = (s, s + float(ev["dur"]), str(ev.get("name", "")))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(span)
        elif cat in HOST_CATS:
            host.append(span)
            if span[2] == WINDOW:
                window = span[:2]
    if window is None:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    return Trace(window, device, host)
