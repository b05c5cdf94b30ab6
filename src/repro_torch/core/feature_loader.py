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
        """Masked gather of ``(..., d)`` rows, as the JAX ``FeatureStore.gather``:
        INVALID comes back as a zero row and every other id is clamped into
        ``[0, V)`` (``-2`` gives row 0).  On a CUDA device the rows come from
        the ``gather`` kernel, on the CPU from its plain version; both zero
        only INVALID here, since every other id is in range after the clamp."""
        from repro_torch.kernels.gather import gather

        ids = ids.to(self.features.device, torch.int32)
        V = self.features.shape[0]
        return gather(self.features, torch.where(ids == INVALID, ids, ids.clamp(0, V - 1)))

    def count_fetched(self, ids) -> int:
        """Rows actually transferred from storage (unique per PE batch)."""
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        if ids.ndim == 1:
            u = np.unique(ids)
            return int((u != INVALID).sum())
        return sum(self.count_fetched(row) for row in ids)

    def count_duplicates_across_pes(self, per_pe_ids) -> int:
        """Extra fetches Independent pays vs a perfectly-shared fetch."""
        if isinstance(per_pe_ids, torch.Tensor):
            per_pe_ids = per_pe_ids.cpu().numpy()
        per_pe_ids = np.asarray(per_pe_ids)
        per_pe_unique = self.count_fetched(per_pe_ids)
        global_unique = int((np.unique(per_pe_ids.ravel()) != INVALID).sum())
        return per_pe_unique - global_unique
