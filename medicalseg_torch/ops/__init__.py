# Copyright 2026. Apache License 2.0.
from . import conv5, hu_resize, intensity, resize, spatial, updown
from .hu_resize import hu_norm_resize
from .intensity import (fixed_norm, hu_norm, label_remap, min_max_norm,
                        normalize, scale_by_max)
from .resize import (crop_resize3d, resize3d, resize3d_batch,
                     resize_to_spacing)
from .spatial import (crop3d, flip3d, random_flip3d, rotate3d,
                      rotate3d_shear)

__all__ = ["conv5", "hu_resize", "intensity", "resize", "spatial", "updown",
           "hu_norm_resize", "hu_norm", "min_max_norm", "fixed_norm",
           "normalize", "label_remap", "scale_by_max", "resize3d",
           "resize3d_batch", "resize_to_spacing", "crop_resize3d", "flip3d",
           "random_flip3d", "crop3d", "rotate3d", "rotate3d_shear"]
