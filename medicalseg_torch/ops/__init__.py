# Copyright 2026. Apache License 2.0.
from . import conv5, hu_resize, intensity, resize, updown
from .hu_resize import hu_norm_resize
from .intensity import (fixed_norm, hu_norm, label_remap, min_max_norm,
                        normalize, scale_by_max)
from .resize import resize3d, resize3d_batch, resize_to_spacing

__all__ = ["conv5", "hu_resize", "intensity", "resize", "updown",
           "hu_norm_resize", "hu_norm", "min_max_norm", "fixed_norm",
           "normalize", "label_remap", "scale_by_max", "resize3d",
           "resize3d_batch", "resize_to_spacing"]
