# Copyright 2026. Apache License 2.0.
"""Preprocessing ops with a device / host backend switch.

Counterpart of ``tools/preprocess_utils/__init__.py``: a process-global
switch, read from the port's own ``tools/preprocess_globals.yml`` (key
``use_device``, or the reference's ``use_gpu``), chooses between the
port's torch ops on the device (:mod:`medicalseg_torch.ops`) and numpy /
scipy on the host. Each op takes and returns numpy arrays.

With the switch on the ops run on ``device()``: ``cuda`` unless
:func:`set_device` names ``cpu`` (the tests run the device backend's torch
ops on the CPU that way). With ``cuda`` and no GPU they raise; they never
fall back to the host backend.

Both spellings of the HU window, ``HUnorm`` and ``HUNorm``, are exported
(the reference's prepare_msd.py imports the second).
"""

import os

import numpy as np
import torch
import yaml

from ...utils.utils import resolve_device

_cfg_path = os.path.join(os.path.dirname(__file__), "..",
                         "preprocess_globals.yml")
global_var = {"use_device": True, "device": "cuda"}
if os.path.exists(_cfg_path):
    with open(_cfg_path) as f:
        loaded = yaml.safe_load(f) or {}
    # the reference key 'use_gpu' is an alias of 'use_device'
    if "use_gpu" in loaded:
        global_var["use_device"] = bool(loaded["use_gpu"])
    if "use_device" in loaded:
        global_var["use_device"] = bool(loaded["use_device"])


def use_device():
    return global_var["use_device"]


def set_use_device(flag):
    global_var["use_device"] = bool(flag)


def device():
    """The device of the device backend; raises for ``cuda`` without a
    GPU."""
    return resolve_device(global_var["device"])


def set_device(name):
    """``cuda`` (the default) or ``cpu``: where the device backend runs."""
    global_var["device"] = str(name)


def _on_device(array):
    # a reader's array may be read-only or strided: torch takes neither
    return torch.from_numpy(np.require(array, requirements=["C", "W"])).to(
        device())


# ---------------------------------------------------------------------------
# value ops (reference values.py:37-87)
# ---------------------------------------------------------------------------

def HUnorm(image, HU_min=-1200, HU_max=600, HU_nan=-2000, multiply_255=True):
    """CT Hounsfield windowing to [0, 255] (or [0, 1])."""
    if use_device():
        from ... import ops
        out = ops.hu_norm(_on_device(image), float(HU_min), float(HU_max),
                          float(HU_nan)).cpu().numpy()
        return out if multiply_255 else out / 255.0
    image = np.nan_to_num(np.asarray(image, np.float32), nan=HU_nan)
    image = (image - HU_min) / float(HU_max - HU_min)
    np.clip(image, 0.0, 1.0, out=image)
    return image * 255.0 if multiply_255 else image


HUNorm = HUnorm


def normalize(image, min_val=None, max_val=None):
    """Min-max normalize with optional fixed bounds (values.py:54-64)."""
    if use_device():
        from ... import ops
        return ops.normalize(_on_device(image), min_val,
                             max_val).cpu().numpy()
    image = np.asarray(image, np.float32)
    lo = np.min(image) if min_val is None else min_val
    hi = np.max(image) if max_val is None else max_val
    return np.clip((image - lo) / max(hi - lo, 1e-12), 0.0, 1.0)


def label_remap(label, map_dict=None):
    """Dict-driven label id rewrite (values.py:37-51)."""
    if map_dict is None:
        return np.asarray(label)
    if use_device():
        from ... import ops
        return ops.label_remap(_on_device(label), map_dict).cpu().numpy()
    label = np.asarray(label).copy()
    out = label.copy()
    for src, dst in map_dict.items():
        out[label == src] = dst
    return out


# ---------------------------------------------------------------------------
# geometry ops (reference geometry.py:31-69)
# ---------------------------------------------------------------------------

def resample(image, spacing=None, new_spacing=(1.0, 1.0, 1.0),
             new_shape=None, order=1):
    """Spacing- or shape-driven zoom (reference geometry.py:31-69:
    spacing / new_spacing / new_shape in the volume's own axis order;
    4-D spacings trimmed). Returns (resampled, new_spacing)."""
    if use_device():
        from ...ops import resize_to_spacing
        out, real_spacing = resize_to_spacing(
            _on_device(image), spacing, new_spacing=new_spacing,
            new_shape=new_shape, order=order)
        return out.cpu().numpy(), real_spacing
    import scipy.ndimage
    image = np.asarray(image)
    in_dhw = np.asarray(image.shape[:3], np.float64)
    if spacing is not None:
        spacing = np.asarray(spacing, np.float64)
        if spacing.size == 4:
            spacing = spacing[1:]
    if new_shape is None:
        new_shape = np.round(
            in_dhw * spacing[:3] / np.asarray(new_spacing, np.float64))
    else:
        new_shape = np.asarray(new_shape, np.float64)
        new_spacing = tuple((in_dhw / new_shape) * spacing[:3]) \
            if spacing is not None else None
    out = scipy.ndimage.zoom(image, new_shape / in_dhw, mode="nearest",
                             order=order)
    return out, new_spacing


# ---------------------------------------------------------------------------
# io helpers (reference load_image.py:32-71)
# ---------------------------------------------------------------------------

def load_series(directory):
    from ...io import dicom
    return dicom.read_series(directory)


def add_qform_sform(path):
    """The reference repairs broken nibabel qform/sform headers
    (load_image.py:58-71); the port's reader falls back to pixdim spacing
    when both codes are 0, so no repair is needed."""
    return path


from .dataset_json import parse_msd_basic_info  # noqa: E402,F401
from .uncompress import uncompressor  # noqa: E402,F401
