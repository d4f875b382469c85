# Copyright 2026. Apache License 2.0.
"""File discovery and CLI helpers after ``medicalseg_tpu/utils/utils.py``
(the port imports nothing of the JAX package)."""

import os

import torch

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


def get_image_list(image_path):
    """Medical image files under ``image_path`` (a file or a directory,
    searched recursively), by suffix, sorted. As reference
    utils.py:142-202 without its suffix and keyword filters, which no
    caller of the port sets."""

    def keep(fname):
        return fname.lower().endswith(MEDICAL_SUFFIXES)

    image_list = []
    if os.path.isfile(image_path):
        if not keep(os.path.basename(image_path)):
            raise FileNotFoundError("{} does not end in one of {}".format(
                image_path, MEDICAL_SUFFIXES))
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
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu (or "
                           "device='cpu') to run on the CPU")
    return torch.device(name)
