from repro_torch.data.recsys import RecsysDataset, make_recsys, recsys_graph

__all__ = ["RecsysDataset", "make_recsys", "recsys_graph"]
