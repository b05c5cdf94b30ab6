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
        """Masked gather; INVALID rows come back as zeros."""
        V = self.features.shape[0]
        ids = ids.to(self.features.device)
        h = self.features[ids.clamp(0, V - 1).long()]
        return torch.where((ids != INVALID)[..., None], h, 0.0)

    def count_fetched(self, ids) -> int:
        """Rows actually transferred from storage (unique per PE batch)."""
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        if ids.ndim == 1:
            u = np.unique(ids)
            return int((u != INVALID).sum())
        return sum(self.count_fetched(row) for row in ids)
