"""Training on one device: the port of the JAX package's ``training/``
(``trainer.py``, ``checkpoint.py``) with ``optim.py``, the port's own
counterpart of the optax pieces its recipe composes."""

from quorum_tpu_torch.training.trainer import (TrainState, loss_fn, make_optimizer,
                                               make_train_step, train_init)

__all__ = ["TrainState", "loss_fn", "make_optimizer", "make_train_step", "train_init"]
