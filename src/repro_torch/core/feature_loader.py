"""Feature loading with fetch accounting (port of ``repro.core.feature_loader``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph import INVALID


@dataclass
class FeatureStore:
    """Vertex-embedding storage (one tensor on one device) with fetch accounting."""

    features: torch.Tensor  # (V, d)

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        """Masked gather of ``(..., d)`` rows; INVALID (and any id outside
        ``[0, V)``) comes back as a zero row.  On a CUDA device this is the
        ``gather`` kernel, on the CPU its plain version.

        This follows the ``paged_gather`` kernel it ports, not the JAX
        ``FeatureStore.gather``: that one zeros only INVALID and clamps
        every other id to ``[0, V)`` (``-2`` gives row 0).  The two agree on
        every id a plan holds (INVALID and ids in ``[0, V)``)."""
        from repro_torch.kernels.gather import gather

        return gather(self.features, ids.to(self.features.device, torch.int32))

    def count_fetched(self, ids) -> int:
        """Rows actually transferred from storage (unique per PE batch)."""
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        if ids.ndim == 1:
            u = np.unique(ids)
            return int((u != INVALID).sum())
        return sum(self.count_fetched(row) for row in ids)
