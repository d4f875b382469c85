# Copyright 2026. Apache License 2.0.
from . import logger, loss_utils, transplant
from .transplant import flax_from_state_dict, state_dict_from_flax
from .utils import get_image_list, resolve_device, strtobool

__all__ = ["logger", "loss_utils", "transplant", "state_dict_from_flax",
           "flax_from_state_dict", "get_image_list", "resolve_device",
           "strtobool"]
