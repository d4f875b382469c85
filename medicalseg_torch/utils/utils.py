# Copyright 2026. Apache License 2.0.
"""File discovery, CLI, seeding, environment and array-dump helpers after
``medicalseg_tpu/utils/utils.py`` and ``env.py`` (the port imports nothing
of the JAX package)."""

import os
import platform
import random
import sys

import numpy as np
import torch

from .. import io as medio
from . import logger

MEDICAL_SUFFIXES = ("nii.gz", "nii", "dcm", "mhd", "mha", "raw", "npy",
                    "nrrd")


def strtobool(v):
    """argparse-friendly bool: the reference's ``type=bool`` flags parse
    '--flag False' as True (any non-empty string is truthy — its
    val.py:57 wart); this accepts yes/no/true/false/1/0 properly."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("y", "yes", "t", "true", "on", "1"):
        return True
    if s in ("n", "no", "f", "false", "off", "0"):
        return False
    import argparse
    raise argparse.ArgumentTypeError(
        "expected a boolean, got {!r}".format(v))


def get_image_list(image_path, valid_suffix=None, filter_key=None):
    """Medical image files under ``image_path`` (a file or a directory,
    searched recursively), sorted. As reference utils.py:142-202:
    ``valid_suffix`` whitelists suffixes (default: every medical suffix);
    ``filter_key`` is a dict of {keyword: bool}, and a file is kept only
    if, for every keyword, (keyword in its name) == bool."""
    if valid_suffix is None:
        valid_suffix = MEDICAL_SUFFIXES

    def keep(fname):
        if not fname.lower().endswith(tuple(s.lower() for s in valid_suffix)):
            return False
        return all((key in fname) == val
                   for key, val in (filter_key or {}).items())

    image_list = []
    if os.path.isfile(image_path):
        if not keep(os.path.basename(image_path)):
            raise FileNotFoundError(
                "{} is not a file with valid suffix {} and filter {}".format(
                    image_path, valid_suffix, filter_key))
        image_list.append(image_path)
    elif os.path.isdir(image_path):
        for root, _, fnames in os.walk(image_path):
            image_list.extend(os.path.join(root, f) for f in fnames
                              if keep(f))
    else:
        raise FileNotFoundError(
            "`image_path` is not found: {}".format(image_path))

    if len(image_list) == 0:
        raise RuntimeError("There are no images in {}".format(image_path))
    return sorted(image_list)


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asked
    for ``cpu``; raises when CUDA was asked for and no GPU is present."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu (or "
                           "device='cpu') to run on the CPU")
    return device


def strict_f32():
    """The float32 policy the port's f32 route is built and checked for:
    cuDNN's convolutions and float32 matrix products in full float32
    (``allow_tf32`` False for both; PyTorch's default leaves cuDNN's on,
    and TF32 keeps a 10-bit mantissa). The hand kernels keep f32 accuracy
    in split TF32 whatever these flags say; the flags govern what runs
    through cuDNN and cuBLAS beside them (the up/down convs, the
    deep-supervision heads). bf16 operands are not affected. Every entry
    point calls this at its start; it sets process-wide flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def seed_all(seed=None):
    """Seed python's, numpy's and torch's global generators (the
    reference's train.py:120-123); a no-op for None."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_sys_env():
    """Platform, Python, numpy, torch, CUDA and the cards torch sees, for
    the train CLI's log (reference sys_env.py:26-121)."""
    env = {"platform": platform.platform(),
           "Python": sys.version.replace("\n", ""),
           "numpy": np.__version__, "torch": torch.__version__,
           "CUDA": torch.version.cuda or "none",
           "GPUs": torch.cuda.device_count() if torch.cuda.is_available()
           else 0}
    if env["GPUs"]:
        env["GPU"] = torch.cuda.get_device_name(0)
        env["cuDNN"] = torch.backends.cudnn.version()
    return env


def save_array(save_path, save_content, form, image_infor):
    """Save a dict of arrays as .npy and/or .nii.gz with their geometry:
    the eval dump of the first volumes (reference utils.py:205-256).

    ``save_content`` maps name -> array (z, y, x), ``form`` is an iterable
    subset of {"npy", "nii.gz", "nii"}, ``image_infor`` holds the
    ``spacing_resample`` (or ``spacing``), ``origin`` and
    ``direction_resample`` (or ``direction``) of dataset.json, x, y, z
    order; what is missing falls back to unit spacing, zero origin and the
    identity. Returns ``save_path``.
    """
    if not isinstance(save_content, dict):
        raise TypeError("save_content should be dict, got {}".format(
            type(save_content)))
    os.makedirs(save_path, exist_ok=True)
    for name, content in save_content.items():
        content = np.squeeze(np.asarray(content))
        if "npy" in form:
            np.save(os.path.join(save_path, name + ".npy"), content)
        if "nii.gz" in form or "nii" in form:
            suffix = "nii.gz" if "nii.gz" in form else "nii"
            spacing = image_infor.get(
                "spacing_resample", image_infor.get("spacing", (1, 1, 1)))
            direction = image_infor.get(
                "direction_resample",
                image_infor.get("direction", (1, 0, 0, 0, 1, 0, 0, 0, 1)))
            origin = image_infor.get("origin", (0, 0, 0))
            direction = np.asarray(direction, dtype=np.float64).reshape(-1)
            if direction.size != 9:
                direction = np.eye(3).reshape(-1)
            medio.write_image(
                os.path.join(save_path, "{}.{}".format(name, suffix)),
                content.astype(np.float32)
                if content.dtype == np.float64 else content,
                spacing=tuple(np.asarray(spacing, dtype=np.float64)[:3]),
                origin=tuple(np.asarray(origin, dtype=np.float64)[:3]),
                direction=tuple(direction))
    logger.info("Saved arrays {} to {}".format(
        list(save_content.keys()), save_path))
    return save_path
