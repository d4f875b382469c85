# Copyright 2026. Apache License 2.0.
from . import state
from .state import TrainState, make_eval_step, make_train_step

__all__ = ["state", "TrainState", "make_train_step", "make_eval_step"]
