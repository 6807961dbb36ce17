"""Training over the port: copies of ``repro.train`` (the loss, the train
step, the ``Trainer`` with checkpoint/restart and fault recovery)."""

from repro_torch.train.loss import lm_loss
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import RecoverableFailure, Trainer

__all__ = ["RecoverableFailure", "Trainer", "init_train_state", "lm_loss", "make_train_step"]
