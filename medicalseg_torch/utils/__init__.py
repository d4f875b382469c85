# Copyright 2026. Apache License 2.0.
from . import env, logger, loss_utils, metric, quant, transplant, visualize
from .checkpoint import (is_valid_checkpoint, load_checkpoint,
                         load_entire_model, load_pretrained_model, resume,
                         save_checkpoint, save_checkpoint_async,
                         wait_pending_checkpoints)
from .config_check import config_check
from .progbar import Progbar
from .timer import TimeAverager, calculate_eta
from .transplant import flax_from_state_dict, state_dict_from_flax
from .utils import (get_image_list, get_sys_env, resolve_device, save_array,
                    seed_all, strict_f32, strtobool)

__all__ = ["logger", "loss_utils", "metric", "quant", "transplant",
           "visualize", "env", "state_dict_from_flax", "flax_from_state_dict",
           "get_image_list", "resolve_device", "strtobool", "seed_all",
           "strict_f32",
           "get_sys_env", "save_array", "Progbar", "TimeAverager",
           "calculate_eta", "config_check", "save_checkpoint",
           "save_checkpoint_async", "wait_pending_checkpoints",
           "is_valid_checkpoint", "load_checkpoint",
           "load_pretrained_model", "load_entire_model",
           "resume", *env.__all__]


def __getattr__(name):
    # the home directories, read (and a sub-home created) at each access
    if name in env.__all__:
        return getattr(env, name)
    raise AttributeError("module {!r} has no attribute {!r}".format(
        __name__, name))
