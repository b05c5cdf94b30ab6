"""Known-bad fixture: a wrapper with untyped or missing preconditions.

The contracts pass must flag both probes with RA107: a 1-D table raises
a plain ``ValueError``, and int64 ids reach ``_build.launch`` unchecked
(the kernel reads int32).
"""
import torch

from repro_torch.kernels import _build


def loose_gather(table, ids):
    if table.ndim != 2:
        raise ValueError("want a (V, d) table")
    out = torch.empty((ids.shape[0], table.shape[1]), device=table.device)
    _build.launch("gather", "gather_launch", table, ids, out, ids.shape[0],
                  table.shape[1], table.shape[0], 0, 32, 1)
    return out


ANALYSIS_TARGETS = [
    {
        "fn": "loose_gather",
        "args": lambda device: ((torch.zeros((64, 8), device=device),
                                 torch.zeros((16,), dtype=torch.int32, device=device)), {}),
        "bad_args": [
            lambda device: ((torch.zeros((64,), device=device),
                             torch.zeros((16,), dtype=torch.int32, device=device)), {}),
            lambda device: ((torch.zeros((64, 8), device=device),
                             torch.zeros((16,), dtype=torch.int64, device=device)), {}),
        ],
    },
]
