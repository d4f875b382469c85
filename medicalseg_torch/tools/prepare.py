# Copyright 2026. Apache License 2.0.
"""Prep: offline preprocessing pipeline base class.

Counterpart of ``tools/prepare.py`` (the reference's tools/prepare.py:
46-453): extraction of local archives, medical-file enumeration with
suffix / keyword filters (multi-dir datasets and a test split included),
decoding by the port's pure-numpy readers (nii / mha / mhd / nrrd / dcm;
4-D volumes split into 3-D modalities; LPS reorientation), a per-file
preprocess op pipeline (HU windowing / normalize / resample: the port's
torch ops on the GPU, or numpy / scipy, by ``preprocess_utils``' switch),
float32 / int32 ``.npy`` emission, 80/20 (or custom) train / val list
files, and an nnU-Net-style dataset.json with per-file geometry.

The reference downloads its archives; the port never does. ``urls`` name
archives on this machine (plain paths or ``file://`` URLs); any other URL
raises.
"""

import json
import os
import os.path as osp
import time

import numpy as np

from .. import io as medio
from ..utils import get_image_list, logger
from ..utils.download import local_path
from .preprocess_utils import uncompressor, use_device


def reorient_to_lps(data, meta):
    """Permute/flip voxel axes so the direction matrix is closest to
    identity in the LPS frame (the reference relies on
    sitk.DICOMOrient(img, 'LPS'), prepare.py:178-180)."""
    direction = np.asarray(meta.get("direction",
                                    (1, 0, 0, 0, 1, 0, 0, 0, 1)),
                           np.float64).reshape(3, 3)
    spacing = np.asarray(meta.get("spacing", (1, 1, 1)), np.float64)
    # column j of `direction` = patient-space direction of voxel axis j
    # (x-fastest ordering). Build the nearest permutation+sign matrix.
    perm = np.argmax(np.abs(direction), axis=0)  # world axis per vox axis
    if len(set(perm.tolist())) != 3:
        return data, meta  # degenerate; leave untouched
    signs = np.sign(direction[perm, np.arange(3)])

    # voxel array is (z, y, x) = axes (2, 1, 0) in xyz ordering
    new_data = data
    for vox_axis in range(3):
        if signs[vox_axis] < 0:
            new_data = np.flip(new_data, axis=2 - vox_axis)
    # transpose so that voxel axis j maps to world axis j
    order_xyz = np.argsort(perm)  # world -> voxel
    new_data = np.transpose(new_data,
                            axes=[2 - order_xyz[2], 2 - order_xyz[1],
                                  2 - order_xyz[0]])
    new_meta = dict(meta)
    new_meta["spacing"] = tuple(spacing[order_xyz])
    new_meta["direction"] = tuple(np.eye(3).reshape(-1))
    return np.ascontiguousarray(new_data), new_meta


def local_archives(dataset_root, names):
    """The archives of ``names`` that lie under ``dataset_root``."""
    return [osp.join(dataset_root, n) for n in names
            if osp.isfile(osp.join(dataset_root, n))]


class Prep:
    """See module docstring. Subclasses configure paths/URLs and call
    :meth:`load_save` + :meth:`generate_txt`."""

    def __init__(self,
                 dataset_root="data/TemDataSet",
                 raw_dataset_dir="TemDataSet_seg_raw/",
                 images_dir="train_imgs",
                 labels_dir="train_labels",
                 phase_dir="phase0",
                 urls=None,
                 valid_suffix=("nii.gz", "nii"),
                 filter_key=(None, None),
                 uncompress_params={"format": "zip", "num_files": 1},
                 images_dir_test=""):
        self.dataset_root = dataset_root
        self.phase_path = osp.join(self.dataset_root, phase_dir)
        self.raw_data_path = osp.join(self.dataset_root, raw_dataset_dir)
        self.image_dir = osp.join(self.raw_data_path, images_dir)
        self.label_dir = osp.join(self.raw_data_path, labels_dir)
        self.urls = urls or {}

        self.image_path = osp.join(self.phase_path, "images")
        self.label_path = osp.join(self.phase_path, "labels")
        os.makedirs(self.dataset_root, exist_ok=True)
        os.makedirs(self.phase_path, exist_ok=True)
        os.makedirs(self.image_path, exist_ok=True)
        os.makedirs(self.label_path, exist_ok=True)

        if self.urls:
            self.uncompress_file(
                num_files=uncompress_params["num_files"],
                form=uncompress_params["format"])

        # enumerate image/label files (multi-dir supported:
        # reference prepare.py:116-134)
        def enumerate_files(root, suffix, fkey):
            if isinstance(root, (list, tuple)):
                files = []
                for r in root:
                    files += get_image_list(r, suffix, fkey)
                return sorted(files)
            return get_image_list(root, suffix, fkey)

        self.image_files = enumerate_files(
            self.image_dir, valid_suffix, filter_key[0]) \
            if osp.exists(str(self.image_dir)) or isinstance(
                self.image_dir, (list, tuple)) else []
        self.label_files = enumerate_files(
            self.label_dir, valid_suffix, filter_key[1]) \
            if osp.exists(str(self.label_dir)) or isinstance(
                self.label_dir, (list, tuple)) else []

        # optional held-out test images (reference prepare.py:105-113)
        self.image_files_test = []
        if images_dir_test:
            self.image_dir_test = osp.join(self.raw_data_path,
                                           images_dir_test)
            self.image_path_test = osp.join(self.phase_path, "images_test")
            os.makedirs(self.image_path_test, exist_ok=True)
            self.image_files_test = get_image_list(
                self.image_dir_test, valid_suffix, filter_key[0])

    # ------------------------------------------------------------------
    def uncompress_file(self, num_files, form):
        """Extract each local archive of ``urls`` into the raw directory
        where it lies (reference prepare.py:137-152, without the
        download)."""
        for url in self.urls.values() if isinstance(self.urls, dict) \
                else self.urls:
            uncompressor._uncompress_file(
                local_path(url), self.raw_data_path, delete_file=False,
                print_progress=True)

    # ------------------------------------------------------------------
    @staticmethod
    def load_medical_data(f):
        """Decode one medical file into a list of (3-D volume, meta).

        Mirrors reference prepare.py:154-198: 4-D nii are split into
        per-modality 3-D volumes; nii are reoriented to LPS; mhd/mha/
        nrrd arrive z,y,x already; .raw is rejected with a pointer to
        its header format.
        """
        data, meta = medio.read_image(f)
        if str(f).lower().endswith((".nii", ".nii.gz")):
            if data.ndim == 3:
                data, meta = reorient_to_lps(data, meta)
        if data.ndim == 4:
            return [(np.ascontiguousarray(data[i]), meta)
                    for i in range(data.shape[0])]
        return [(data, meta)]

    # ------------------------------------------------------------------
    def load_save(self, preprocess=None):
        """Decode -> preprocess pipeline -> .npy (reference
        prepare.py:200-259). ``preprocess`` is {'images': [ops],
        'labels': [ops]} where each op is fn(vol, spacing=None) or
        fn(vol); ops named 'resample' get the per-file spacing and their
        resulting spacing is recorded back into dataset.json.
        """
        logger.info(
            "Start convert images to numpy array using {}, please wait "
            "patiently".format("GPU" if use_device() else "CPU"))

        json_path = osp.join(self.raw_data_path, "dataset.json")
        dataset_json = {}
        if osp.exists(json_path):
            with open(json_path, "r", encoding="utf-8") as f:
                dataset_json = json.load(f)

        tic = time.time()
        pairs = [("images", self.image_files, self.image_path,
                  np.float32),
                 ("labels", self.label_files, self.label_path, np.int32)]
        if self.image_files_test:
            pairs.append(("images_test", self.image_files_test,
                          self.image_path_test, np.float32))

        for kind, files, savepath, dtype in pairs:
            pre_ops = (preprocess or {}).get(
                "images" if kind == "images_test" else kind, [])
            for f in files:
                for idx, (vol, meta) in enumerate(
                        self.load_medical_data(f)):
                    spacing = meta.get("spacing", (1, 1, 1))
                    record = dataset_json.get("training", {}).get(
                        self._json_key(f), None)
                    for op in pre_ops:
                        name = getattr(op, "__name__", "")
                        if "resample" in name:
                            vol, new_spacing = op(vol, spacing=spacing)
                            if record is not None:
                                record["spacing_resample"] = list(
                                    np.asarray(new_spacing, float))
                        else:
                            vol = op(vol)
                    vol = np.asarray(vol).astype(dtype)
                    base = self._npy_name(f, idx)
                    np.save(osp.join(savepath, base), vol)

        if dataset_json:
            with open(json_path, "w", encoding="utf-8") as f:
                json.dump(dataset_json, f, indent=4)
        logger.info("The preprocess time on {} is {:.2f}s".format(
            "GPU" if use_device() else "CPU", time.time() - tic))

    @staticmethod
    def _json_key(fname):
        base = osp.basename(fname)
        for suffix in (".nii.gz", ".nii", ".mhd", ".mha", ".nrrd",
                       ".dcm"):
            if base.lower().endswith(suffix):
                return base[:-len(suffix)]
        return osp.splitext(base)[0]

    @staticmethod
    def _npy_name(fname, idx=0):
        key = Prep._json_key(fname)
        return key + ("" if idx == 0 else "-{}".format(idx)) + ".npy"

    # ------------------------------------------------------------------
    def write_txt(self, txt, image_names, label_names=None):
        """Write "images/x.npy labels/y.npy" lines (reference
        prepare.py:282-303)."""
        with open(txt, "w") as f:
            for i in range(len(image_names)):
                if label_names is not None:
                    string = "{} {}\n".format(
                        "images/" + image_names[i],
                        "labels/" + label_names[i])
                else:
                    string = "{}\n".format("images/" + image_names[i])
                f.write(string)
        logger.info("successfully write to {}".format(txt))

    def split_files_txt(self, txt, image_files, label_files=None,
                        train_split=None):
        """80/20 (default) split into train/val lists; absolute
        ``train_split`` > 1 is a file count (reference
        prepare.py:305-352)."""
        if train_split is None:
            train_split = int(0.8 * len(image_files))
        elif 0 < train_split <= 1:
            train_split = int(train_split * len(image_files))

        image_names = [osp.basename(p) for p in image_files]
        label_names = [osp.basename(p) for p in label_files] \
            if label_files else None

        if "train" in osp.basename(txt):
            image_names = image_names[:train_split]
            label_names = label_names[:train_split] if label_names \
                else None
        elif "val" in osp.basename(txt):
            image_names = image_names[train_split:]
            label_names = label_names[train_split:] if label_names \
                else None
        elif "test" in osp.basename(txt):
            pass
        else:
            raise NotImplementedError(
                "The txt split except for train.txt/val.txt/test.txt is "
                "not implemented yet.")
        self.write_txt(txt, image_names, label_names)

    # ------------------------------------------------------------------
    def generate_dataset_json(self,
                              modalities,
                              labels,
                              dataset_name,
                              license_desc="hands off!",
                              dataset_description="",
                              dataset_reference="",
                              save_path=None):
        """nnU-Net-style dataset.json with per-file geometry (reference
        prepare.py:354-452)."""
        if save_path is None:
            save_path = osp.join(self.raw_data_path, "dataset.json")
        if not save_path.endswith("dataset.json"):
            logger.warning(
                "The dataset.json file should be named dataset.json")

        training = {}
        for f in self.image_files:
            data, meta = medio.read_image(f)
            training[self._json_key(f)] = {
                "image": f,
                "dim": int(data.ndim),
                "shape": list(int(s) for s in data.shape),
                "minmax": [float(np.min(data)), float(np.max(data))],
                "spacing": list(map(float, meta.get("spacing",
                                                    (1, 1, 1)))),
                "origin": list(map(float, meta.get("origin", (0, 0, 0)))),
                "direction": list(map(float, meta.get(
                    "direction", (1, 0, 0, 0, 1, 0, 0, 0, 1)))),
            }

        dataset_json = {
            "name": dataset_name,
            "description": dataset_description,
            "reference": dataset_reference,
            "licence": license_desc,
            "modality": {str(i): str(m) for i, m in enumerate(modalities)},
            "labels": {str(k): str(v) for k, v in labels.items()},
            "numTraining": len(self.image_files),
            "numTest": len(self.image_files_test),
            "training": training,
        }
        with open(save_path, "w", encoding="utf-8") as f:
            json.dump(dataset_json, f, indent=4, sort_keys=False)
        logger.info("dataset.json saved to {}".format(save_path))
        return save_path
