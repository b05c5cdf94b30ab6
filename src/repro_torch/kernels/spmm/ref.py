"""Plain torch versions of the padded-bipartite neighbor aggregation.

The forward loops over the ``w`` slots of a row in order, holds no
``(n, w, d)`` intermediate, and adds in the same order as the CUDA kernel
(equal bit for bit).  The backward adds each source row's gradients in
slot order too, the order of :func:`backward_order`, so it equals the
backward kernel bit for bit on either device.
"""
from __future__ import annotations

import torch


def _degree(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return mask.sum(dim=1, keepdim=True).clamp(min=1).to(dtype)


def spmm_ref(
    src: torch.Tensor,      # (S, d) source embeddings
    nbr_idx: torch.Tensor,  # (n, w) row indices into src, -1 = padding
    mask: torch.Tensor,     # (n, w) bool
    mean: bool = True,
) -> torch.Tensor:
    """out[r] = sum_k mask[r, k] * src[nbr_idx[r, k]] (slot order), divided by
    max(deg, 1) in mean mode; indices are clamped into [0, S).

    On the CPU only the rows with a masked slot are computed, the others
    stay +0.0, as the sum of ``w`` zeros gives (an accumulator that starts
    at +0.0 never becomes -0.0): the same bits, without gathering every
    padding row ``w`` times.  On a card every row is (no host sync, so the
    call can be captured in a CUDA graph).
    """
    n, w = nbr_idx.shape
    idx = nbr_idx.clamp(0, max(src.shape[0] - 1, 0)).long()
    rows = mask.any(dim=1).nonzero().squeeze(1) if src.device.type == "cpu" else None
    if rows is not None:
        idx, mask = idx[rows], mask[rows]
    acc = src.new_zeros((idx.shape[0], src.shape[1]))
    for k in range(w):
        acc = acc + torch.where(mask[:, k, None], src[idx[:, k]], 0.0)
    if mean:
        acc = acc / _degree(mask, acc.dtype)
    return acc if rows is None else src.new_zeros((n, src.shape[1])).index_copy_(0, rows, acc)


def backward_order(nbr_idx: torch.Tensor, mask: torch.Tensor,
                   num_src: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, slots), both int32 ``(n*w,)``: every slot's source row (``num_src``
    for a masked-out slot) sorted stably, and the flat slot index ``r*w + k``
    of each.  Each source row's slots form one run, in slot order."""
    key = torch.where(mask, nbr_idx.clamp(0, max(num_src - 1, 0)), num_src)
    keys, slots = torch.sort(key.reshape(-1).to(torch.int32), stable=True)
    return keys, slots.to(torch.int32)


def spmm_backward_ref(
    grad_out: torch.Tensor,  # (n, d)
    nbr_idx: torch.Tensor,   # (n, w)
    mask: torch.Tensor,      # (n, w) bool
    num_src: int,
    mean: bool = True,
) -> torch.Tensor:
    """grad_src (num_src, d): each masked slot adds its row's output gradient
    (divided by max(deg, 1) in mean mode) into its source row, in slot order.

    Round ``t`` adds the ``t``-th slot of every source row's run; the rows
    of one round are distinct, so each round's ``index_add_`` is exact.
    """
    w = nbr_idx.shape[1]
    g = grad_out / _degree(mask, grad_out.dtype) if mean else grad_out
    keys, slots = backward_order(nbr_idx, mask, num_src)
    grad_src = grad_out.new_zeros((num_src, grad_out.shape[1]))
    e = torch.arange(keys.numel(), device=keys.device)
    starts = torch.ones_like(keys, dtype=torch.bool)
    starts[1:] = keys[1:] != keys[:-1]
    rank = e - torch.cummax(torch.where(starts, e, 0), dim=0).values
    valid = keys < num_src
    rounds = int(rank[valid].max()) + 1 if bool(valid.any()) else 0
    for t in range(rounds):
        sel = valid & (rank == t)
        grad_src.index_add_(0, keys[sel].long(), g[slots[sel].long() // w])
    return grad_src
