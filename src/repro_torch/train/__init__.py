"""LM training on the port: optimizers, gradient compression and the
fault-tolerant training loop."""
from repro_torch.train import compression, optim
from repro_torch.train.loop import (TrainConfig, TrainState,
                                    init_train_state, make_train_step, train)

__all__ = ["optim", "compression", "TrainConfig", "TrainState",
           "init_train_state", "make_train_step", "train"]
