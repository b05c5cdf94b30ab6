"""Classification metrics (port of ``repro.train.metrics``)."""
from __future__ import annotations

import numpy as np
import torch


def masked_softmax_xent_parts(logits, labels, valid):
    """(CE sum over valid rows, valid count): the two pieces a distributed
    step reduces across PEs before dividing."""
    shifted = logits - logits.max(-1, keepdim=True).values
    logz = torch.log(torch.exp(shifted).sum(-1))
    ll = torch.take_along_dim(shifted, labels[:, None].long(), dim=-1)[:, 0]
    ce = logz - ll
    return torch.where(valid, ce, 0.0).sum(), valid.sum()


def masked_softmax_xent(logits, labels, valid):
    """Mean CE over valid rows; logits (n, C), labels (n,), valid (n,)."""
    s, n = masked_softmax_xent_parts(logits, labels, valid)
    return s / n.clamp(min=1)


def micro_f1(preds: np.ndarray, labels: np.ndarray) -> float:
    """Micro-F1 == accuracy for single-label multiclass."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    return float((preds == labels).mean()) if len(preds) else 0.0


def macro_f1(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> float:
    f1s = []
    for c in range(num_classes):
        tp = ((preds == c) & (labels == c)).sum()
        fp = ((preds == c) & (labels != c)).sum()
        fn = ((preds != c) & (labels == c)).sum()
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return float(np.mean(f1s))
