# Copyright 2026. Apache License 2.0.
"""MRISpineSeg dataset (reference medicalseg/datasets/mri_spine_seg.py:
30-69): T2 spine MRI, 20-class vertebra/disc labels, preprocessed to
512x512x12 .npy by tools/prepare_mri_spine_seg.py."""

from ..cvlibs import manager
from .dataset import MedicalDataset

URL = ("https://bj.bcebos.com/v1/ai-studio-online/"
       "3f7063ba6e7f469b8d3e0d2d6b77a5aa33beb5abc02a45afa8f25d4d"
       "04d2aaed")  # reference dataset URL (mri_spine_seg.py:28)


@manager.DATASETS.add_component
class MRISpineSeg(MedicalDataset):
    """num_classes=20 (19 vertebrae/discs + background), ignore 255."""

    def __init__(self,
                 dataset_root=None,
                 result_dir=None,
                 transforms=None,
                 num_classes=None,
                 mode="train",
                 ignore_index=255,
                 dataset_json_path="",
                 repeat_train=10):
        super().__init__(
            dataset_root,
            result_dir,
            transforms or [],
            num_classes,
            mode,
            ignore_index,
            data_URL=URL,
            dataset_json_path=dataset_json_path,
            repeat_train=repeat_train)
