from repro_torch.models.gnn.layers import (
    GNN,
    GATLayer,
    GCNLayer,
    GNNConfig,
    RGCNLayer,
    SAGELayer,
    gnn_apply,
    gnn_apply_cooperative,
    gnn_apply_stacked,
    init_gnn,
    params_from_jax,
)

__all__ = [
    "GATLayer", "GCNLayer", "GNN", "GNNConfig", "RGCNLayer", "SAGELayer", "gnn_apply",
    "gnn_apply_cooperative", "gnn_apply_stacked", "init_gnn", "params_from_jax",
]
