"""Tiered feature store of the port: device CLOCK cache over a host tier."""
from repro_torch.store.clock import (
    ClockAccess,
    ClockCache,
    ClockState,
    clock_access,
    clock_init,
    hash_set,
    unique_rows,
)
from repro_torch.store.kernel import probe_ref, tag_probe, tag_probe_cuda
from repro_torch.store.tiers import TieredFeatureStore

__all__ = [
    "ClockAccess", "ClockCache", "ClockState", "TieredFeatureStore", "clock_access",
    "clock_init", "hash_set", "probe_ref", "tag_probe", "tag_probe_cuda",
    "unique_rows",
]
