from repro_torch.models.gnn.layers import (
    GNN,
    GCNLayer,
    GNNConfig,
    gnn_apply,
    init_gnn,
    params_from_jax,
)

__all__ = ["GCNLayer", "GNN", "GNNConfig", "gnn_apply", "init_gnn", "params_from_jax"]
