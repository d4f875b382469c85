# Copyright 2026. Apache License 2.0.
from . import functional
from .device import DeviceAugmentor, supports as device_supports
from .transform import (BinaryMaskToConnectComponent, Compose,
                        RandomFlip3D, RandomResizedCrop3D,
                        RandomRotation3D, Resize3D,
                        TopkLargestConnectComponent)

__all__ = [
    "Compose", "Resize3D", "RandomRotation3D", "RandomFlip3D",
    "RandomResizedCrop3D", "BinaryMaskToConnectComponent",
    "TopkLargestConnectComponent", "functional", "DeviceAugmentor",
    "device_supports",
]
