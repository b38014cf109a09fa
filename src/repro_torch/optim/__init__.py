"""Optimizer and learning-rate schedules (reference: ``repro/optim``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedules import make_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "make_schedule"]
