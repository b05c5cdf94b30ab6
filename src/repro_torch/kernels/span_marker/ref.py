"""Plain torch version of the span marker: the host's clock
(``time.perf_counter_ns``) stamped into a span's accumulator slots, for
spans recorded on the CPU, where every operation has finished when it
returns."""
from __future__ import annotations

import time

import torch


def span_marker_ref(acc: torch.Tensor, index: int, end: bool) -> None:
    """Begin (``end`` False: ``last = now``) or end (``total += now - last``,
    ``count += 1``) span ``index``, whose slots are ``acc[3 * index:][:3]``
    (total ns, count, last start)."""
    now = time.perf_counter_ns()
    slot = acc[3 * index: 3 * index + 3]
    if end:  # tensor arithmetic only: no read back to the host
        slot[0:1].add_(now - slot[2:3])
        slot[1:2].add_(1)
    else:
        slot[2:3].fill_(now)
