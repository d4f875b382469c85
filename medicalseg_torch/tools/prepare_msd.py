# Copyright 2026. Apache License 2.0.
"""Medical Segmentation Decathlon (MSD) preprocessing.

Counterpart of ``tools/prepare_msd.py`` (the reference's
tools/prepare_msd.py:67-174): the ten Decathlon task archives, HU
windowing + resample to 128^3 (labels order=0), 0.75 split, dataset.json
metadata parsed from the task's own dataset.json. As in the JAX
package's copy, the reference's ``HUNorm`` import mismatch and
``prep.image_dir`` NameError are corrected and ``load_save`` is called
with the preprocess pipeline. Nothing is downloaded: put ``<task>.tar``
under ``data/<task>`` (or extract it into the raw directory yourself).

Usage: python -m medicalseg_torch.tools.prepare_msd 4   # Task04_Hippocampus
"""

import functools
import os
import os.path as osp
import sys

from ..utils import logger
from .prepare import Prep, local_archives
from .preprocess_utils import HUnorm, parse_msd_basic_info, resample

# Task id -> task name (reference prepare_msd.py:67-110)
TASKS = {
    1: "Task01_BrainTumour",
    2: "Task02_Heart",
    3: "Task03_Liver",
    4: "Task04_Hippocampus",
    5: "Task05_Prostate",
    6: "Task06_Lung",
    7: "Task07_Pancreas",
    8: "Task08_HepaticVessel",
    9: "Task09_Spleen",
    10: "Task10_Colon",
}

# The reference downloads each task's archive (prepare_msd.py:67-110)
# from https://msd-for-monai.s3-us-west-2.amazonaws.com/<task>.tar, e.g.
#   https://msd-for-monai.s3-us-west-2.amazonaws.com/Task04_Hippocampus.tar


def wrapped_partial(func, *args, **kwargs):
    partial = functools.partial(func, *args, **kwargs)
    functools.update_wrapper(partial, func)
    return partial


class Prep_msd(Prep):
    def __init__(self, task_id, archives=None):
        """``archives``: local paths or file:// URLs of the task's
        archive, extracted into the raw directory; by default
        ``data/<task>/<task>.tar`` when it is there."""
        if task_id not in TASKS:
            raise ValueError("MSD task id must be in 1..10, got {}".format(
                task_id))
        task_name = TASKS[task_id]
        self.task_name = task_name

        # archives extract to <task>/(<task>/)imagesTr etc.
        dataset_root = osp.join("data", task_name)
        raw_dir = task_name + "_raw/"
        nested = osp.join(task_name, task_name)
        base = nested if osp.exists(
            osp.join(dataset_root, raw_dir, nested)) else task_name

        super().__init__(
            dataset_root=dataset_root,
            raw_dataset_dir=raw_dir,
            images_dir=osp.join(base, "imagesTr"),
            labels_dir=osp.join(base, "labelsTr"),
            phase_dir=task_name + "_phase0/",
            urls=local_archives(dataset_root, [task_name + ".tar"])
            if archives is None else archives,
            valid_suffix=("nii.gz", "nii.gz"),
            # MSD hides originals as ._ files; exclude them
            filter_key=({"._": False}, {"._": False}),
            uncompress_params={"format": "tar", "num_files": 1})

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
        txtname = [
            osp.join(self.phase_path, "train_list.txt"),
            osp.join(self.phase_path, "val_list.txt"),
        ]
        image_files_npy = sorted(os.listdir(self.image_path))
        label_files_npy = sorted(os.listdir(self.label_path))
        for txt in txtname:
            self.split_files_txt(txt, image_files_npy, label_files_npy,
                                 train_split)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(
            "Please provide task id. Example usage: \n\t python -m "
            "medicalseg_torch.tools.prepare_msd 4 # for preparing MSD task "
            "4")
    task_id = int(sys.argv[1])

    prep = Prep_msd(task_id)
    json_path = osp.join(osp.dirname(prep.image_dir), "dataset.json")
    modalities, labels, dataset_name = parse_msd_basic_info(json_path)
    prep.generate_dataset_json(modalities, labels, dataset_name)
    prep.load_save(preprocess=prep.preprocess)
    prep.generate_txt()
    logger.info("{} phase0 ready.".format(prep.task_name))
