# Copyright 2026. Apache License 2.0.
"""Medical image I/O (pure numpy, no SimpleITK/nibabel dependency).

Dispatch layer over the NIfTI / MetaImage / NRRD / DICOM readers. All
readers return ``(data, meta)`` with data in z,y,x order and meta holding
``spacing`` / ``origin`` / ``direction`` in the ITK/LPS convention — the
same contract the reference gets from SimpleITK (tools/prepare.py:154-198).
"""

import os

import numpy as np

from . import dicom, metaimage, nifti, nrrd_io

SUPPORTED_SUFFIXES = (".nii", ".nii.gz", ".mha", ".mhd", ".nrrd", ".dcm",
                      ".npy")


def read_image(path):
    """Read any supported medical image. Returns (data_zyx, meta)."""
    lower = str(path).lower()
    if os.path.isdir(path):
        return dicom.read_series(path)
    if lower.endswith((".nii", ".nii.gz")):
        return nifti.read(path)
    if lower.endswith((".mha", ".mhd")):
        return metaimage.read(path)
    if lower.endswith(".nrrd"):
        return nrrd_io.read(path)
    if lower.endswith((".dcm", ".ima")):
        data, info = dicom.read(path)
        return data[None], {
            "spacing": tuple(info["PixelSpacing"][:2]) +
            (float(info["SliceThickness"]),),
            "origin": tuple(info.get("ImagePositionPatient") or (0, 0, 0)),
            "direction": (1, 0, 0, 0, 1, 0, 0, 0, 1),
            "ndim": 3,
        }
    if lower.endswith(".npy"):
        return np.load(path), {
            "spacing": (1.0, 1.0, 1.0),
            "origin": (0.0, 0.0, 0.0),
            "direction": (1, 0, 0, 0, 1, 0, 0, 0, 1),
            "ndim": 3,
        }
    if lower.endswith(".raw"):
        raise RuntimeError(
            "Can not convert raw files directly; provide a header format "
            "(mhd/mha) instead.")
    raise ValueError("Unsupported image format: {}".format(path))


def write_image(path, data, spacing=(1, 1, 1), origin=(0, 0, 0),
                direction=(1, 0, 0, 0, 1, 0, 0, 0, 1)):
    """Write a z,y,x volume to nii/nii.gz/mha/mhd/nrrd/npy by suffix."""
    lower = str(path).lower()
    if lower.endswith((".nii", ".nii.gz")):
        return nifti.write(path, data, spacing, origin, direction)
    if lower.endswith((".mha", ".mhd")):
        return metaimage.write(path, data, spacing, origin, direction)
    if lower.endswith(".nrrd"):
        return nrrd_io.write(path, data, spacing, origin)
    if lower.endswith(".npy"):
        np.save(path, data)
        return path
    raise ValueError("Unsupported output format: {}".format(path))
