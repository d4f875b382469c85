# Copyright 2026. Apache License 2.0.
from .dataset import MedicalDataset
from .lung_coronavirus import LungCoronavirus
from .mri_spine_seg import MRISpineSeg

__all__ = ["MedicalDataset", "LungCoronavirus", "MRISpineSeg"]
