# Copyright 2026. Apache License 2.0.
"""MRISpineSeg (spine MRI) preprocessing.

Counterpart of ``tools/prepare_mri_spine_seg.py`` (the reference's
tools/prepare_mri_spine_seg.py:51-132): normalize intensities with fixed
bounds [0, 2650] + resample to 512x512x12 (labels order=0), and a
20-class label dictionary collapsing the challenge's sparse ids into
contiguous ones. Nothing is downloaded: put ``train.zip`` under the
dataset root (or extract it into the raw directory yourself).

Usage: python -m medicalseg_torch.tools.prepare_mri_spine_seg
"""

import functools
import os.path as osp

from ..utils import logger
from .prepare import Prep, local_archives
from .preprocess_utils import label_remap, normalize, resample

# The dataset's archive, which the reference downloads
# (prepare_mri_spine_seg.py:52-54) from:
#   train.zip https://bj.bcebos.com/v1/ai-studio-online/4e1d24412c8b40b082ed871775ea3e090ce49a83e38b4dbd89cc44b586790108
ARCHIVES = ("train.zip",)

# challenge label ids -> contiguous 20-class ids
# (reference prepare_mri_spine_seg.py label dict)
LABEL_DICT_20 = {
    0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8, 9: 9, 10: 10,
    11: 11, 12: 12, 13: 13, 14: 14, 15: 15, 16: 16, 17: 17, 18: 18,
    19: 19, 20: 19,
}


def wrapped_partial(func, *args, **kwargs):
    partial = functools.partial(func, *args, **kwargs)
    functools.update_wrapper(partial, func)
    return partial


class Prep_mri_spine(Prep):
    def __init__(self, dataset_root="data/MRSpineSeg", archives=None):
        """``archives``: local paths or file:// URLs of the dataset's
        archive, extracted into the raw directory; by default
        :data:`ARCHIVES` found under ``dataset_root``."""
        if archives is None:
            archives = local_archives(dataset_root, ARCHIVES)
        super().__init__(
            dataset_root=dataset_root,
            raw_dataset_dir="MRI_spine_seg_raw/",
            images_dir="train/MR",
            labels_dir="train/Mask",
            phase_dir="MRI_spine_seg_phase0_class20_big_12/",
            urls=archives,
            valid_suffix=("nii.gz", "nii"),
            filter_key=(None, None),
            uncompress_params={"format": "zip", "num_files": 1})

        self.preprocess = {
            "images": [
                wrapped_partial(normalize, min_val=0, max_val=2650),
                wrapped_partial(resample, new_shape=[512, 512, 12],
                                order=1)],
            "labels": [
                wrapped_partial(label_remap, map_dict=LABEL_DICT_20),
                wrapped_partial(resample, new_shape=[512, 512, 12],
                                order=0)],
        }

    def generate_txt(self, train_split=0.8):
        """Image/label lists; label file 'mask_case*' pairs with image
        'Case*' (reference prepare_mri_spine_seg.py:82-98)."""
        txtname = [
            osp.join(self.phase_path, "train_list.txt"),
            osp.join(self.phase_path, "val_list.txt"),
        ]
        image_files = [self._npy_name(p) for p in self.image_files]
        label_files = ["mask_" + name.lower() if not
                       name.lower().startswith("mask_") else name
                       for name in image_files]
        for txt in txtname:
            self.split_files_txt(txt,
                                 [osp.join(self.image_path, f)
                                  for f in image_files],
                                 [osp.join(self.label_path, f)
                                  for f in label_files],
                                 train_split=train_split)


if __name__ == "__main__":
    prep = Prep_mri_spine()
    prep.generate_dataset_json(
        modalities=("MRI-T2",),
        labels={str(i): str(i) for i in range(20)},
        dataset_name="MRISpineSeg",
        dataset_description="T2 spine MRI, 20-class vertebra/disc labels",
        license_desc="https://www.spinesegmentation-challenge.com/"
                     "wp-content/uploads/2021/12/Term-of-use.pdf",
        dataset_reference="https://www.spinesegmentation-challenge.com/")
    prep.load_save(preprocess=prep.preprocess)
    prep.generate_txt()
    logger.info("MRI_spine_seg phase0 ready.")
