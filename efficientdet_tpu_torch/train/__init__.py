"""Training and serving steps of the PyTorch port."""

from .graphed import graphed_eval_step
from .train_lib import (OptimizerConfig, PlateauScheduler, TrainState,
                        create_train_state, get_learning_rate,
                        make_eval_step, make_loss_step, make_optimizer,
                        make_train_step, maybe_normalize_images,
                        set_learning_rate)

__all__ = ["OptimizerConfig", "PlateauScheduler", "TrainState",
           "create_train_state", "get_learning_rate", "graphed_eval_step",
           "make_eval_step", "make_loss_step", "make_optimizer",
           "make_train_step", "maybe_normalize_images", "set_learning_rate"]
