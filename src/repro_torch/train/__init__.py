"""The training step and loop (reference: ``repro/train``)."""
from .step import (TrainHParams, abstract_train_state, init_train_state,
                   make_train_step, train_state_logical_specs)
from .trainer import Trainer, TrainerConfig

__all__ = ["TrainHParams", "init_train_state", "make_train_step",
           "abstract_train_state", "train_state_logical_specs", "Trainer",
           "TrainerConfig"]
