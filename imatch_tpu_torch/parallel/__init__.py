"""Multi-device paths and training: the row-sharded index engines over a
device list, and the contrastive training step (one device)."""

from imatch_tpu_torch.parallel.train import (
    TrainState,
    clip_loss,
    init_train_state,
    make_train_step,
)

__all__ = [
    "TrainState",
    "clip_loss",
    "make_train_step",
    "init_train_state",
]
