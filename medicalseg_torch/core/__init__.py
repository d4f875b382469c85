# Copyright 2026. Apache License 2.0.
from . import infer, loader, prefetch, sliding_window, state, val
from .infer import inference
from .loader import EvalLoader, TrainLoader
from .prefetch import DevicePrefetcher
from .sliding_window import (sliding_window_inference,
                             sliding_window_inference_batched)
from .state import TrainState, make_eval_step, make_train_step
from .train import train
from .val import evaluate

__all__ = ["infer", "loader", "prefetch", "sliding_window", "state", "val",
           "TrainState", "make_train_step", "make_eval_step", "inference",
           "sliding_window_inference", "sliding_window_inference_batched",
           "TrainLoader", "EvalLoader", "DevicePrefetcher", "train",
           "evaluate"]
