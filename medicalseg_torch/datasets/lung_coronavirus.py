# Copyright 2026. Apache License 2.0.
"""COVID-19 CT scans dataset (reference
medicalseg/datasets/lung_coronavirus.py:30-69): 20 labeled CT volumes
with lung/infection masks, preprocessed to 128^3 .npy by
tools/prepare_lung_coronavirus.py."""

from ..cvlibs import manager
from .dataset import MedicalDataset

URL = ("https://bj.bcebos.com/v1/ai-studio-online/"
       "432237969243497caad5e3f8a31f86fce8b25a0aed394fbb95e8a"
       "0b2e28da1c9")  # reference dataset URL (lung_coronavirus.py:28)


@manager.DATASETS.add_component
class LungCoronavirus(MedicalDataset):
    """num_classes=3 (background / lung / infection), ignore 255."""

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
