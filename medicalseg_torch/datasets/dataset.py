# Copyright 2026. Apache License 2.0.
"""MedicalDataset: a file-list dataset over preprocessed ``.npy`` volumes.

Counterpart of ``medicalseg_tpu/datasets/dataset.py`` (the reference's
medicalseg/datasets/dataset.py:29-125): it reads ``{train,val,test}_list.txt``
("image_rel label_rel" pairs under ``dataset_root``), repeats the train
list ``repeat_train`` times (x10 by default) to amortize epoch restarts,
and applies the Compose transforms in ``__getitem__``, returning (im,
label, image_path). ``raw_item`` gives the untransformed pair for the
device augmentation path.

``dataset_root=None`` asks for the reference's download, which the port
does not do: it raises; give the directory that
``tools/generate_synthetic_dataset.py`` or the port's prep tools
(``medicalseg_torch/tools/prepare_*.py``) wrote.
"""

import os

import numpy as np

from ..cvlibs import manager
from ..transforms import Compose


@manager.DATASETS.add_component
class MedicalDataset:
    """
    Args:
        dataset_root: directory holding the phase0 npy data + list files.
        result_dir: directory for next-phase results.
        transforms: list of transform objects (wrapped in Compose).
        num_classes: number of classes.
        mode: 'train' | 'val' | 'test'.
        ignore_index: label value ignored by losses.
        data_URL: the reference's download source (not fetched).
        dataset_json_path: nnU-Net-style geometry metadata.
        repeat_train: train list repetition factor.
    """

    def __init__(self,
                 dataset_root,
                 result_dir,
                 transforms,
                 num_classes,
                 mode="train",
                 ignore_index=255,
                 data_URL="",
                 dataset_json_path="",
                 repeat_train=10):
        self.dataset_root = dataset_root
        self.result_dir = result_dir
        self.raw_transforms = transforms
        self.transforms = Compose(transforms)
        self.file_list = list()
        self.mode = mode.lower()
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.dataset_json_path = dataset_json_path

        if self.dataset_root is None:
            raise NotImplementedError(
                "dataset_root is None: the reference downloads the dataset "
                "from {!r}, the port does not; prepare the raw data with "
                "the port's prep tools (python -m "
                "medicalseg_torch.tools.prepare_<dataset>) and set "
                "dataset_root to the phase0 directory they write".format(
                    data_URL))
        if not os.path.exists(self.dataset_root):
            raise ValueError(
                "The `dataset_root` don't exist please specify the correct "
                "path to data.")

        if self.mode not in ("train", "val", "test"):
            raise ValueError(
                "`mode` should be 'train', 'val' or 'test', but got {}."
                .format(mode))
        file_path = os.path.join(self.dataset_root,
                                 self.mode + "_list.txt")
        with open(file_path, "r") as f:
            for line in f:
                items = line.strip().split()
                if len(items) != 2:
                    raise ValueError(
                        "File list format incorrect! It should be"
                        " image_name label_name\\n")
                self.file_list.append(
                    [os.path.join(self.dataset_root, items[0]),
                     os.path.join(self.dataset_root, items[1])])

        if self.mode == "train":
            self.file_list = self.file_list * repeat_train

    def __getitem__(self, idx):
        return self.item(idx)

    def item(self, idx, rng=None):
        """``self[idx]`` with the transforms' draws from ``rng`` (a
        ``numpy.random.Generator``; the loader's host mode seeds one a
        sample)."""
        image_path, label_path = self.file_list[idx]
        im, label = self.transforms(im=image_path, label=label_path, rng=rng)
        return im, label, image_path

    def raw_item(self, idx):
        """Untransformed (image, label) numpy pair for the device
        augmentation path."""
        image_path, label_path = self.file_list[idx]
        return np.load(image_path), np.load(label_path)

    def __len__(self):
        return len(self.file_list)
