# Copyright 2026. Apache License 2.0.
from . import layers, losses
from .vnet import VNet
from .vnet_deepsup import VNetDeepSup

__all__ = ["layers", "losses", "VNet", "VNetDeepSup"]
