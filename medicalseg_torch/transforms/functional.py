# Copyright 2026. Apache License 2.0.
"""Host-side functional transforms (numpy/scipy).

A copy of ``medicalseg_tpu/transforms/functional.py`` (the port imports
nothing of the JAX package): the reference's
medicalseg/transforms/functional.py:25-131. These run on the host in the
loader's ``host`` mode; training batches normally take the device
augmentor (:mod:`medicalseg_torch.transforms.device`), whose ops in
:mod:`medicalseg_torch.ops` follow the same conventions.
"""

import collections.abc

import numpy as np
import scipy.ndimage


def _is_numpy_image(img):
    return isinstance(img, np.ndarray) and (img.ndim in {2, 3, 4})


def resize_3d(img, size, order=1):
    """Resize via endpoint-aligned zoom (reference functional.py:25-58):
    int size = short-side target; 3-sequence = (d, h, w)."""
    if not _is_numpy_image(img):
        raise TypeError(
            "img should be numpy image. Got {}".format(type(img)))
    if not (isinstance(size, int) or
            (isinstance(size, collections.abc.Iterable) and
             len(size) == 3)):
        raise TypeError("Got inappropriate size arg: {}".format(size))
    d, h, w = img.shape[0], img.shape[1], img.shape[2]

    if isinstance(size, int):
        if min(d, h, w) == size:
            return img
        ow = int(size * w / min(d, h, w))
        oh = int(size * h / min(d, h, w))
        od = int(size * d / min(d, h, w))
    else:
        ow, oh, od = size[2], size[1], size[0]

    if img.ndim == 3:
        resize_factor = np.array([od, oh, ow]) / img.shape
    else:
        resize_factor = np.array([od, oh, ow, img.shape[3]]) / img.shape
    return scipy.ndimage.zoom(img, resize_factor, mode="nearest",
                              order=order)


def crop_3d(img, i, j, k, d, h, w):
    if not _is_numpy_image(img):
        raise TypeError(
            "img should be numpy image. Got {}".format(type(img)))
    return img[i:i + d, j:j + h, k:k + w]


def flip_3d(img, axis):
    return np.flip(img, axis)


def rotate_3d(img, r_plane, angle, order=1, cval=0):
    return scipy.ndimage.rotate(img, angle=angle, axes=r_plane, order=order,
                                cval=cval, reshape=False)


def resized_crop_3d(img, i, j, k, d, h, w, size, interpolation):
    assert _is_numpy_image(img), "img should be numpy image"
    img = crop_3d(img, i, j, k, d, h, w)
    return resize_3d(img, size, order=interpolation)


def extract_connect_compoent(binary_mask, minimum_volume=0):
    """Connected components labeled by decreasing volume (replaces the
    reference's SimpleITK ConnectedComponent+RelabelComponent,
    functional.py:117-131) with scipy.ndimage.label + relabel-by-size.
    0 is background; components smaller than minimum_volume are dropped.
    """
    uniq = np.unique(binary_mask)
    assert len(uniq) < 3, \
        "Only binary mask is accepted, got mask with {}.".format(
            uniq.tolist())
    labeled, num = scipy.ndimage.label(binary_mask)
    if num == 0:
        return np.zeros_like(np.asarray(binary_mask), dtype=np.int32)
    counts = np.bincount(labeled.ravel())
    counts[0] = 0  # background
    order = np.argsort(counts)[::-1]  # component ids by decreasing size
    relabel = np.zeros(num + 1, dtype=np.int32)
    next_id = 1
    for comp_id in order:
        if comp_id == 0 or counts[comp_id] == 0:
            continue
        if counts[comp_id] < minimum_volume:
            continue
        relabel[comp_id] = next_id
        next_id += 1
    return relabel[labeled]
