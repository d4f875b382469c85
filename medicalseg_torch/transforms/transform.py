# Copyright 2026. Apache License 2.0.
"""Config-driven host transforms.

A copy of ``medicalseg_tpu/transforms/transform.py`` (the port imports
nothing of the JAX package), capability parity with the reference's
medicalseg/transforms/transform.py (27-396), around two concerns:

  * **Sampling contract** — module-level ``_draw_*`` functions hold
    every RNG interaction. Their call *order and distributions* are the
    reference recipes' (and the JAX package's); do not reorder them. They
    draw from a ``numpy.random.Generator`` handed to them (``rng``), not
    from python's ``random`` or numpy's global generator, so that the
    loader can seed each sample's draws from (seed, batch number, row) and the
    draws do not depend on thread order or on the process (a rank of a
    process mesh makes its rows of the global batch as one process
    would). Without one they take a generator seeded from numpy's global
    generator (``utils.seed`` makes that reproducible).
  * **Paired application** — :class:`_PairedOp` samples parameters once
    and applies them to image and label with per-role interpolation
    orders.

These host ops run in the loader's ``host`` mode; training batches
normally take the device augmentor (:mod:`.device`), which reads the same
transform objects' parameters.
"""

import numbers
from collections import namedtuple
from collections.abc import Iterable

import numpy as np

from ..cvlibs import manager
from . import functional as F

# ---------------------------------------------------------------------
# Sampling contract (reference transform.py:143-152, 185-190, 242-323).
# Do not reorder draws.
# ---------------------------------------------------------------------

CropBox = namedtuple("CropBox", ["i", "j", "k", "d", "h", "w"])


def _generator(rng=None):
    """``rng``, or a generator seeded from numpy's global generator."""
    if rng is None:
        return np.random.default_rng(np.random.randint(1 << 31))
    return rng


def _draw_crop_box(shape, scale, ratio, rng):
    """Rejection-sample a crop box: up to 10 proposals of a random
    volume fraction x aspect ratio, optionally axis-permuted, accepted
    when it fits; falls back to the centered short-side cube.

    Draws per attempt: uniform(scale), uniform(ratio), random() gate,
    [a permutation of 3], then three integers on acceptance.
    """
    D, H, W = int(shape[0]), int(shape[1]), int(shape[2])
    for _ in range(10):
        frac = rng.uniform(*scale)
        aspect = rng.uniform(*ratio)
        vol = frac * D * H * W
        dims = [int(round((vol * aspect) ** (1. / 3))),
                int(round((vol / aspect) ** (1. / 3))),
                W]
        if rng.random() < 0.5:
            dims = [dims[i] for i in rng.permutation(3)]
        d, h, w = dims
        if d <= D and h <= H and w <= W:
            return CropBox(int(rng.integers(0, D - d, endpoint=True)),
                           int(rng.integers(0, H - h, endpoint=True)),
                           int(rng.integers(0, W - w, endpoint=True)),
                           d, h, w)
    side = min(D, H, W)
    return CropBox((D - side) // 2, (H - side) // 2, (W - side) // 2,
                   side, side, side)


def _draw_precrop_box(shape, scale, size, rng, bbox=None):
    """Sample the pre-crop window: target extents = size scaled by one
    uniform(low, high, 3) draw, clamped to the (bbox-restricted) volume;
    origin = one integer per axis in z, y, x order.

    Returns (starts[3], extents[3]) numpy int arrays.
    """
    want = (rng.uniform(scale[0], scale[1], size=3)
            * np.asarray(size)).round().astype("int")
    lo = np.zeros(3, dtype=np.int64)
    full = np.asarray(shape[:3], dtype=np.int64)
    if bbox is not None:
        lo, hi = bbox
        full = hi - lo
    take = np.minimum(full, want)
    room = full - take + 1
    starts = np.array([rng.integers(room[0]), rng.integers(room[1]),
                       rng.integers(room[2])]) + lo
    return starts, take


def _draw_rotation(degrees, planes, rng):
    """angle ~ uniform(degrees), plane ~ one of ``planes``."""
    angle = rng.uniform(degrees[0], degrees[1])
    plane = planes[int(rng.integers(len(planes)))]
    return angle, plane


def _draw_flip(axes, prob, rng):
    """Axis is drawn *before* the probability gate (reference
    transform.py:185-190 order); returns the axis or None to skip."""
    if isinstance(axes, (tuple, list)):
        axis = axes[int(rng.integers(len(axes)))]
    else:
        axis = axes
    return axis if rng.random() < prob else None


# ---------------------------------------------------------------------
# Shared scaffolding
# ---------------------------------------------------------------------

def _size3(size, scalar_expand):
    """Validate a size argument: 3-sequence -> tuple; int -> tripled
    when ``scalar_expand`` else kept scalar (short-side semantics)."""
    if isinstance(size, int):
        return (size,) * 3 if scalar_expand else size
    if isinstance(size, Iterable):
        size = tuple(size)
        if len(size) == 3:
            return size
    raise ValueError(
        "size needs an int or a 3-sequence, got {!r}".format(size))


def _label_bbox(label):
    """Inclusive-exclusive bounding box of the nonzero label region."""
    coords = np.where(label != 0)
    lo = np.array([int(np.min(c)) for c in coords])
    hi = np.array([int(np.max(c)) + 1 for c in coords])
    return lo, hi


class _PairedOp:
    """Sample-once / apply-twice template for (image, label) pairs.

    Subclasses implement ``_params(img, label, rng)`` (all RNG happens
    here, via the module sampling functions, from the generator ``rng``)
    and ``_apply(arr, params, is_label)``; an optional ``_pre`` hook runs
    before sampling (used by the pre-crop stage, whose own draws precede
    the main ones).
    """

    def _pre(self, img, label, rng):
        return img, label

    def _params(self, img, label, rng):
        return None

    def _apply(self, arr, params, is_label):
        raise NotImplementedError

    def __call__(self, img, label=None, rng=None):
        rng = _generator(rng)
        img, label = self._pre(img, label, rng)
        params = self._params(img, label, rng)
        img = self._apply(img, params, is_label=False)
        if label is not None:
            label = self._apply(label, params, is_label=True)
        return img, label


# ---------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------

@manager.TRANSFORMS.add_component
class Compose:
    """Thread (im, label) through an op list, then add the channel axis
    and normalize by the per-volume max (reference transform.py:27-71).
    Accepts ``.npy`` paths or in-memory arrays; the random ops draw from
    ``rng`` (a ``numpy.random.Generator``; module docstring).
    """

    def __init__(self, transforms):
        if not isinstance(transforms, list):
            raise TypeError(
                "Compose wants a list of transforms, got {!r}".format(
                    type(transforms)))
        self.transforms = transforms

    @staticmethod
    def _materialize(x):
        return np.load(x) if isinstance(x, str) else x

    def __call__(self, im, label=None, rng=None):
        im = self._materialize(im)
        label = self._materialize(label)
        if im is None:
            raise ValueError("Compose got an unreadable image")
        rng = _generator(rng)
        for op in self.transforms:
            out = op(im, label, rng)
            im = out[0]
            if len(out) > 1:
                label = out[1]
        im = im[np.newaxis]
        peak = im.max()
        if peak > 0:
            im = im / peak
        return im, label


@manager.TRANSFORMS.add_component
class Resize3D(_PairedOp):
    """Deterministic zoom to (d, h, w), or short-side scaling for int
    sizes; labels always resample nearest-neighbor (reference
    transform.py:74-109)."""

    def __init__(self, size, order=1):
        self.size = _size3(size, scalar_expand=False)
        self.order = order

    def _apply(self, arr, params, is_label):
        return F.resize_3d(arr, self.size, 0 if is_label else self.order)


@manager.TRANSFORMS.add_component
class RandomRotation3D(_PairedOp):
    """Rotate by a uniform angle in ``±degrees`` within one random plane
    of ``rotate_planes`` (reference transform.py:112-166). Labels warp
    with the same order-1 interpolation the reference uses (its
    transform.py:163-165 passes the default order for labels too); the
    int dtype rounds after the warp."""

    def __init__(self, degrees, rotate_planes=None):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError(
                    "scalar degrees must be non-negative, got "
                    "{}".format(degrees))
            degrees = (-degrees, degrees)
        elif len(degrees) != 2:
            raise ValueError(
                "degrees needs a scalar or a (lo, hi) pair, got "
                "{!r}".format(degrees))
        self.degrees = tuple(degrees)
        self.rotate_planes = rotate_planes or [[0, 1], [0, 2], [1, 2]]

    def get_params(self, degrees, rng=None):
        return _draw_rotation(degrees, self.rotate_planes, _generator(rng))

    def _params(self, img, label, rng):
        return self.get_params(self.degrees, rng)

    def _apply(self, arr, params, is_label):
        angle, plane = params
        return F.rotate_3d(arr, plane, angle)


@manager.TRANSFORMS.add_component
class RandomFlip3D(_PairedOp):
    """Probability-gated mirror along one randomly drawn axis
    (reference transform.py:169-203)."""

    def __init__(self, prob=0.5, flip_axis=None):
        self.prob = prob
        self.flip_axis = [0, 1, 2] if flip_axis is None else flip_axis

    def _params(self, img, label, rng):
        return _draw_flip(self.flip_axis, self.prob, rng)

    def _apply(self, arr, axis, is_label):
        return arr if axis is None else F.flip_3d(arr, axis=axis)


@manager.TRANSFORMS.add_component
class RandomResizedCrop3D(_PairedOp):
    """Random-scale/aspect crop, zoomed to ``size`` (reference
    transform.py:206-339). ``pre_crop`` first trims a near-target-size
    window — restricted to the label's nonzero bounding box when
    ``nonzero_mask`` — which is the patch-sampling mode the
    sliding-window recipes rely on."""

    def __init__(self, size, scale=(0.8, 1.2), ratio=(3. / 4., 4. / 3.),
                 interpolation=1, pre_crop=False, nonzero_mask=False):
        self.size = _size3(size, scalar_expand=True)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation
        self.pre_crop = pre_crop
        self.nonzero_mask = nonzero_mask

    def get_params(self, img, scale, ratio, rng=None):
        return _draw_crop_box(img.shape, scale, ratio, _generator(rng))

    def pre_crop_util(self, img, label=None, rng=None):
        if not self.pre_crop:
            return img, label
        bbox = _label_bbox(label) if self.nonzero_mask else None
        (z, y, x), (dz, dy, dx) = _draw_precrop_box(
            img.shape, self.scale, self.size, _generator(rng), bbox=bbox)
        window = (slice(z, z + dz), slice(y, y + dy), slice(x, x + dx))
        img = img[window]
        if label is not None:
            label = label[window]
        return img, label

    def _pre(self, img, label, rng):
        return self.pre_crop_util(img, label, rng)

    def _params(self, img, label, rng):
        return self.get_params(img, self.scale, self.ratio, rng)

    def _apply(self, arr, box, is_label):
        order = 0 if is_label else self.interpolation
        return F.resized_crop_3d(arr, box.i, box.j, box.k, box.d, box.h,
                                 box.w, self.size, order)


# ---------------------------------------------------------------------
# Post-processing (prediction cleanup; reference transform.py:342-396)
# ---------------------------------------------------------------------

class _ComponentOp(_PairedOp):
    """Connected-component relabeling shared base: components come back
    numbered 1..k by decreasing voxel count (functional.py)."""

    min_volume = 0

    def _apply(self, arr, params, is_label):
        return F.extract_connect_compoent(arr, self.min_volume)


@manager.TRANSFORMS.add_component
class BinaryMaskToConnectComponent(_ComponentOp):
    """Split a binary mask into size-ranked components, dropping those
    under ``minimum_volume`` voxels."""

    def __init__(self, minimum_volume=0):
        self.min_volume = minimum_volume

    # unusually for a transform, the reference relabels the *label* too
    # when one is passed (transform.py:342-368) — _PairedOp covers it


@manager.TRANSFORMS.add_component
class TopkLargestConnectComponent(_ComponentOp):
    """Zero out everything but the ``k`` largest components."""

    def __init__(self, k=1):
        self.k = k

    def __call__(self, pred, label=None, rng=None):
        pred = self._apply(pred, None, is_label=False)
        pred[pred > self.k] = 0
        return pred, label
