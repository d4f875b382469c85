# Copyright 2026. Apache License 2.0.
from . import infer, sliding_window, state
from .infer import inference
from .sliding_window import (sliding_window_inference,
                             sliding_window_inference_batched)
from .state import TrainState, make_eval_step, make_train_step

__all__ = ["infer", "sliding_window", "state", "TrainState",
           "make_train_step", "make_eval_step", "inference",
           "sliding_window_inference", "sliding_window_inference_batched"]
