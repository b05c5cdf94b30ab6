"""Training of the port: the cooperative (or independent) GNN train step."""
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.loop import (
    TrainConfig,
    TrainResult,
    evaluate,
    make_loss_fn,
    step_program,
    train_gnn,
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
    "cosine_lr", "evaluate", "load_checkpoint", "macro_f1", "make_loss_fn",
    "masked_softmax_xent", "masked_softmax_xent_parts", "micro_f1", "save_checkpoint",
    "sgd_update", "step_program", "train_gnn",
]
