# Copyright 2026. Apache License 2.0.
"""Promise12 / multi-site Prostate-MRI preprocessing.

Counterpart of ``tools/prepare_prostate.py`` (the reference's
tools/prepare_prostate.py:50-196): two dataset layouts behind one script: Promise12 (mhd across three TrainingData_Part
dirs + a held-out TestData dir) and Prostate_mri (six sites of nii.gz),
both using the ``filter_key={'segmentation': bool}`` filename filter to
separate images from labels, normalize + resample to 512x512x24, and an
images_test passthrough (normalize only).

Usage: python -m medicalseg_torch.tools.prepare_prostate Promise12
       python -m medicalseg_torch.tools.prepare_prostate Prostate_mri
"""

import functools
import os
import os.path as osp
import sys

from ..utils import logger
from .prepare import Prep
from .preprocess_utils import normalize, resample

# the reference hosts no direct urls for these (Promise12 needs
# registration; Prostate_mri is a Google Drive share,
# prepare_prostate.py:50-57) — place the archives under dataset_root
# manually, then run this script.
DATASET_ADDR = {
    "Promise12": {
        "dataset_root": "data/Promise12",
        "raw_dataset_dir": "Promise12_raw",
        "images_dir": ("prostate/TrainingData_Part1",
                       "prostate/TrainingData_Part2",
                       "prostate/TrainingData_Part3"),
        "labels_dir": ("prostate/TrainingData_Part1",
                       "prostate/TrainingData_Part2",
                       "prostate/TrainingData_Part3"),
        "images_dir_test": "prostate/TestData",
        "phase_dir": "Promise12_phase0/",
        "urls": {},
        "valid_suffix": ("mhd", "mhd"),
        "filter_key": ({"segmentation": False}, {"segmentation": True}),
        "uncompress_params": {"format": "zip", "num_files": 1},
    },
    "Prostate_mri": {
        "dataset_root": "data/Prostate_mri",
        "raw_dataset_dir": "Prostate_mri_raw",
        "images_dir": tuple(
            "Processed_data_nii/" + site for site in
            ("BIDMC", "BMC", "HK", "I2CVB", "RUNMC", "UCL")),
        "labels_dir": tuple(
            "Processed_data_nii/" + site for site in
            ("BIDMC", "BMC", "HK", "I2CVB", "RUNMC", "UCL")),
        "phase_dir": "Prostate_mri_phase0/",
        "urls": {},
        "valid_suffix": ("nii.gz", "nii.gz"),
        "filter_key": ({"segmentation": False}, {"segmentation": True}),
        "uncompress_params": {"format": "zip", "num_files": 1},
    },
}

DATASET_PROFILE = {
    "Promise12": {
        "modalities": ("MRI-T2",),
        "labels": {0: "Background", 1: "prostate"},
        "dataset_name": "Promise12",
        "dataset_description": "Transversal T2-weighted prostate MR, "
                               "multi-center multi-vendor.",
        "license_desc": "",
        "dataset_reference":
            "https://promise12.grand-challenge.org/Details/",
    },
    "Prostate_mri": {
        "modalities": ("MRI-T2",),
        "labels": {0: "Background", 1: "prostate"},
        "dataset_name": "Prostate_mri",
        "dataset_description": "Multi-site T2-weighted prostate MRI from "
                               "six data sources.",
        "license_desc": "",
        "dataset_reference": "https://liuquande.github.io/SAML/",
    },
}


def wrapped_partial(func, *args, **kwargs):
    partial = functools.partial(func, *args, **kwargs)
    functools.update_wrapper(partial, func)
    return partial


class Prep_prostate(Prep):
    def __init__(self, addr):
        images_dir = addr["images_dir"]
        labels_dir = addr["labels_dir"]
        raw = osp.join(addr["dataset_root"], addr["raw_dataset_dir"])
        # multi-dir datasets: join each sub-dir onto the raw root
        images_dir = [osp.join(raw, d) for d in images_dir] \
            if isinstance(images_dir, (list, tuple)) else images_dir
        labels_dir = [osp.join(raw, d) for d in labels_dir] \
            if isinstance(labels_dir, (list, tuple)) else labels_dir

        super().__init__(
            dataset_root=addr["dataset_root"],
            raw_dataset_dir=addr["raw_dataset_dir"],
            images_dir="", labels_dir="",
            phase_dir=addr["phase_dir"],
            urls=addr["urls"],
            valid_suffix=addr["valid_suffix"],
            filter_key=addr["filter_key"],
            uncompress_params=addr["uncompress_params"],
            images_dir_test=addr.get("images_dir_test", ""))
        # re-enumerate with the multi-dir roots
        from ..utils import get_image_list

        def multi(dirs, fkey):
            files = []
            for d in (dirs if isinstance(dirs, list) else [dirs]):
                if osp.exists(d):
                    files += get_image_list(d, addr["valid_suffix"], fkey)
            return sorted(files)

        self.image_files = multi(images_dir, addr["filter_key"][0])
        self.label_files = multi(labels_dir, addr["filter_key"][1])

        self.preprocess = {
            "images": [
                normalize,
                wrapped_partial(resample, new_shape=[512, 512, 24],
                                order=1)],
            "labels": [
                wrapped_partial(resample, new_shape=[512, 512, 24],
                                order=0)],
            "images_test": [normalize],
        }

    def generate_txt(self, train_split=0.8):
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
    if len(sys.argv) != 2 or sys.argv[1] not in DATASET_ADDR:
        raise SystemExit(
            "Usage: python -m medicalseg_torch.tools.prepare_prostate "
            "[Promise12|Prostate_mri]")
    name = sys.argv[1]
    prep = Prep_prostate(DATASET_ADDR[name])
    prep.generate_dataset_json(**DATASET_PROFILE[name])
    prep.load_save(preprocess=prep.preprocess)
    prep.generate_txt()
    logger.info("{} phase0 ready.".format(name))
