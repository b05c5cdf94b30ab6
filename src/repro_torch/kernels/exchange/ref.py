"""Plain torch versions of the single-device valid-rows exchange.

With every PE on one device the request gather, the all-to-all and the
slot scatter of a cooperative layer compose into one index map (see
``exchange.cu``).  :func:`exchange_tables_ref` inverts the plan's two
tables into it; the forward is a row gather through it and the backward
adds each row's requesters' gradients, peer ascending, in the same order
as the kernel (equal bit for bit).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gather.ref import gather_ref


def exchange_tables_ref(
    slot_to_tilde: torch.Tensor,  # (P, P, cap_b): [p, q, s] -> row of PE p's output
    req_idx: torch.Tensor,        # (P, P, cap_b): [q, p, s] -> row of PE q's H
    cap_tilde: int,
    cap_next: int,
    backward: bool,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(fwd_src, bwd_src)``: for each output row ``p * cap_tilde + t`` the
    flat row ``q * cap_next + r`` of ``H`` it copies (``(P, cap_tilde)``),
    and with ``backward`` for each row ``q * cap_next + r`` of ``H`` the
    flat output row of each requester ``p`` (``(P, cap_next, P)``); -1
    wherever there is none.  A slot counts where both of its indices are
    in range."""
    P = slot_to_tilde.shape[0]
    dev = slot_to_tilde.device
    t = slot_to_tilde.long()
    r = req_idx.transpose(0, 1).long()  # [p, q, s]
    ok = (t >= 0) & (t < cap_tilde) & (r >= 0) & (r < cap_next)
    pe = torch.arange(P, device=dev)
    out_row = (pe[:, None, None] * cap_tilde + t)[ok]
    h_row = (pe[None, :, None] * cap_next + r)[ok]
    fwd_src = torch.full((P * cap_tilde,), -1, dtype=torch.int32, device=dev)
    fwd_src[out_row] = h_row.to(torch.int32)
    bwd_src = None
    if backward:
        peer = pe[:, None, None].expand_as(t)[ok]
        bwd_src = torch.full((P * cap_next * P,), -1, dtype=torch.int32, device=dev)
        bwd_src[h_row * P + peer] = out_row.to(torch.int32)
        bwd_src = bwd_src.reshape(P, cap_next, P)
    return fwd_src.reshape(P, cap_tilde), bwd_src


def exchange_forward_ref(H: torch.Tensor, fwd_src: torch.Tensor) -> torch.Tensor:
    """``(P, cap_tilde, d)``: each output row the row of ``H`` (``(P,
    cap_next, d)``) that ``fwd_src`` names, or a zero row."""
    d = H.shape[-1]
    return gather_ref(H.reshape(-1, d), fwd_src.reshape(-1)).reshape(*fwd_src.shape, d)


def exchange_backward_ref(grad_out: torch.Tensor, bwd_src: torch.Tensor) -> torch.Tensor:
    """``(P, cap_next, d)``: each row of ``H``'s gradient, the sum over its
    requesters ``p`` ascending of their rows of ``grad_out`` (``(P,
    cap_tilde, d)``), starting from +0.0 and adding +0.0 for a peer that
    did not ask."""
    d = grad_out.shape[-1]
    g = grad_out.reshape(-1, d)
    src = bwd_src.reshape(-1, bwd_src.shape[-1])
    acc = g.new_zeros((src.shape[0], d))
    for w in range(src.shape[1]):
        acc = acc + gather_ref(g, src[:, w])
    return acc.reshape(*bwd_src.shape[:-1], d)
