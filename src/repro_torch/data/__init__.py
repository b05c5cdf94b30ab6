from repro_torch.data.recsys import RecsysDataset, make_recsys, recsys_graph
from repro_torch.data.synthetic import SyntheticGraphDataset, rmat_edges, rmat_graph
from repro_torch.data.tokens import synthetic_token_batch

__all__ = [
    "RecsysDataset", "SyntheticGraphDataset", "make_recsys", "recsys_graph",
    "rmat_edges", "rmat_graph", "synthetic_token_batch",
]
