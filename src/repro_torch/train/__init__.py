"""Training of the port: the cooperative (or independent) GNN train step."""
from repro_torch.train.loop import (
    TrainConfig,
    TrainResult,
    evaluate,
    make_loss_fn,
    train_gnn,
    train_step,
)
from repro_torch.train.metrics import (
    macro_f1,
    masked_softmax_xent,
    masked_softmax_xent_parts,
    micro_f1,
)
from repro_torch.train.optim import AdamState, adam_init, adam_update, cosine_lr, sgd_update

__all__ = [
    "AdamState", "TrainConfig", "TrainResult", "adam_init", "adam_update",
    "cosine_lr", "evaluate", "macro_f1", "make_loss_fn", "masked_softmax_xent",
    "masked_softmax_xent_parts", "micro_f1", "sgd_update", "train_gnn", "train_step",
]
