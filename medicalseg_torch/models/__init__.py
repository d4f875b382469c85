# Copyright 2026. Apache License 2.0.
from . import layers, losses
from .vnet import VNet

__all__ = ["layers", "losses", "VNet"]
