"""Plain torch versions of the masked per-destination edge softmax (GAT).

The forward follows ``repro/kernels/seg_softmax/ref.py`` step for step:
``-1e9`` on masked slots, the row max over the ``w`` slots, ``exp``, zero
on masked slots, division by ``max(sum, 1e-20)``.  The backward is what
autodiff of that function gives: ``alpha * (g - sum_w alpha * g)`` on
valid slots and 0 elsewhere.

Both sums over the ``w`` slots add in the order of the CUDA kernel's warp
(:func:`warp_sum`), so on a card the plain versions and the kernels do
the same float32 operations in the same order.
"""
from __future__ import annotations

import torch

WARP = 32
NEG = -1e9


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in the order of a 32-lane warp: lane ``k`` adds slots
    ``k, k+32, k+64, ...`` in turn, then the lanes are added pairwise,
    16 apart, 8 apart, ... 1 apart (a shuffle-xor butterfly)."""
    n, w = x.shape[:2]
    chunks = max(1, -(-w // WARP))
    pad = x.new_zeros((n, chunks * WARP - w, *x.shape[2:]))
    lanes = torch.cat([x, pad], dim=1).reshape(n, chunks, WARP, *x.shape[2:])
    acc = lanes[:, 0]
    for c in range(1, chunks):
        acc = acc + lanes[:, c]
    off = WARP // 2
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0]


def _slot_mask(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return mask[..., None] if e.ndim == 3 else mask


def seg_softmax_ref(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over dim 1 restricted to valid slots; masked slots are 0.

    e: (n, w) or (n, w, h) float logits; mask: (n, w) bool.
    """
    m = _slot_mask(e, mask)
    masked = torch.where(m, e, NEG)
    mx = masked.amax(dim=1, keepdim=True)
    ex = torch.where(m, torch.exp(masked - mx), 0.0)
    denom = warp_sum(ex).unsqueeze(1).clamp_min(1e-20)
    return ex / denom


def seg_softmax_backward_ref(alpha: torch.Tensor, grad: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """Gradient of the logits from the softmax ``alpha`` and the output
    gradient ``grad`` (both shaped like the logits)."""
    m = _slot_mask(alpha, mask)
    s = warp_sum(torch.where(m, alpha * grad, 0.0)).unsqueeze(1)
    return torch.where(m, alpha * (grad - s), 0.0)
