# Copyright 2026. Apache License 2.0.
"""COVID-19 CT scans preprocessing.

Counterpart of ``tools/prepare_lung_coronavirus.py`` (the reference's
tools/prepare_lung_coronavirus.py:55-126): four archives (scans / lung
masks / infection masks / ncov scans), HU windowing + resample to 128^3
(labels order=0), 0.75 train split, and a label-filename normalization so
image/label pairs line up. Nothing is downloaded: put the archives under
the dataset root (or extract them into the raw directory yourself).

Expected raw layout after extraction::

    lung_coronavirus_raw/
        20_ncov_scan/*.nii.gz       (images)
        lung_mask/*.nii.gz          (labels)

Usage: python -m medicalseg_torch.tools.prepare_lung_coronavirus
"""

import functools
import os.path as osp

from ..utils import logger
from .prepare import Prep, local_archives
from .preprocess_utils import HUnorm, resample

# The dataset's archives, which the reference downloads
# (prepare_lung_coronavirus.py:55-64) from:
#   Lung_Infection.zip https://bj.bcebos.com/v1/ai-studio-online/432237969243497caa4d389c33797ddb2a9fa877f3104e4a9a63bd31a79e4fb8
#   Lung_Mask.zip      https://bj.bcebos.com/v1/ai-studio-online/96f299c5beb046b4a973fafb3c39048be8d5f860bd0d47659b92116a3cd8a9bf
#   Infection_Mask.zip https://bj.bcebos.com/v1/ai-studio-online/2b867932e42f4977b46bfbad4fba93aa158f16c79910400b975305c0bd50b638
#   20_ncov_scan.zip   https://bj.bcebos.com/v1/ai-studio-online/12b02c4d5f9d44c5af53d17bbd4f100888b5be1dbc3d40d6b444f383540bd36c
ARCHIVES = ("Lung_Infection.zip", "Lung_Mask.zip", "Infection_Mask.zip",
            "20_ncov_scan.zip")


def wrapped_partial(func, *args, **kwargs):
    partial = functools.partial(func, *args, **kwargs)
    functools.update_wrapper(partial, func)
    return partial


class Prep_lung_coronavirus(Prep):
    def __init__(self, dataset_root="data/lung_coronavirus", archives=None):
        """``archives``: local paths or file:// URLs of the dataset's
        archives, extracted into the raw directory; by default those of
        :data:`ARCHIVES` found under ``dataset_root``."""
        if archives is None:
            archives = local_archives(dataset_root, ARCHIVES)
        super().__init__(
            dataset_root=dataset_root,
            raw_dataset_dir="lung_coronavirus_raw/",
            images_dir="20_ncov_scan",
            labels_dir="lung_mask",
            phase_dir="lung_coronavirus_phase0/",
            urls=archives,
            valid_suffix=("nii.gz", "nii"),
            filter_key=(None, None),
            uncompress_params={"format": "zip", "num_files": 4})

        self.preprocess = {
            "images": [
                HUnorm,
                wrapped_partial(resample, new_shape=[128, 128, 128],
                                order=1)],
            "labels": [
                wrapped_partial(resample, new_shape=[128, 128, 128],
                                order=0)],
        }

    def generate_txt(self, train_split=0.75):
        """Image/label lists; label filenames differ only by a prefix
        (reference prepare_lung_coronavirus.py:92-110)."""
        txtname = [
            osp.join(self.phase_path, "train_list.txt"),
            osp.join(self.phase_path, "val_list.txt"),
        ]
        image_files = [self._npy_name(p) for p in self.image_files]
        label_files = [
            name.replace("_org_covid-19-pneumonia-",
                         "_").replace("-dcm", "").replace("_org_", "_")
            for name in image_files
        ]
        for txt in txtname:
            self.split_files_txt(txt,
                                 [osp.join(self.image_path, f)
                                  for f in image_files],
                                 [osp.join(self.label_path, f)
                                  for f in label_files],
                                 train_split=train_split)


if __name__ == "__main__":
    prep = Prep_lung_coronavirus()
    prep.generate_dataset_json(
        modalities=("CT",),
        labels={0: "background", 1: "lung", 2: "infection"},
        dataset_name="COVID-19 CT scans",
        dataset_description="20 CT scans with lung and infection masks",
        license_desc="CC BY 4.0",
        dataset_reference="https://www.kaggle.com/andrewmvd/covid19-ct-scans")
    prep.load_save(preprocess=prep.preprocess)
    prep.generate_txt()
    logger.info("lung_coronavirus phase0 ready.")
