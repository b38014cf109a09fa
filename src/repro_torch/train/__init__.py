"""The training step (reference: ``repro/train``)."""
from .step import TrainHParams, init_train_state, make_train_step

__all__ = ["TrainHParams", "init_train_state", "make_train_step"]
