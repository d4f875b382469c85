# Copyright 2026. Apache License 2.0.
"""Device augmentation: the head of the training step, on the batch's
device.

Counterpart of ``medicalseg_tpu/transforms/device.py``. The loader ships
raw phase0 volumes and the step augments them where they already are:

  * RandomResizedCrop3D -> :func:`~medicalseg_torch.ops.resize.
    crop_resize3d` (with the ``pre_crop`` / ``nonzero_mask`` modes);
  * RandomRotation3D    -> :func:`~medicalseg_torch.ops.spatial.
    rotate3d_shear` up to 45 degrees, :func:`~medicalseg_torch.ops.
    spatial.rotate3d` beyond; labels are rotated with order 1 and rounded,
    as the reference does (its transform.py:163-165);
  * RandomFlip3D        -> a flip along the drawn axis;
  * Resize3D            -> :func:`~medicalseg_torch.ops.resize.resize3d`;

then Compose's channel axis and divide-by-max tail.

It is split in two. The **sampler** draws each sample's parameters on the
host from a CPU generator seeded from the augmentor's seed and the seed of
the generator the step hands it (the state's; the train loop re-seeds that
one from (seed, step) before every step, so a resumed run draws what the
unbroken run drew, as the JAX step's ``fold_in(key, step)`` does); its
maps from uniform draws to crop
windows (:func:`crop_params`, :func:`pre_crop_params`,
:func:`nonzero_bbox`) are pure functions of those draws with the JAX
package's distributions (10 rejection attempts, the axis permutation with
p = 0.5, the centre-cube fallback), so a test can feed them the draws that
``jax.random`` made. The **apply** step (:meth:`DeviceAugmentor.apply`)
runs given parameters on a batch. The plane and the flip are host values
that pick a code path; only a crop inside the label's bounding box
(``nonzero_mask``) depends on data on the card, and its window is computed
there. No call reads a value back from the card.
"""

import numpy as np
import torch

from ..ops import intensity, resize, spatial
from ..parallel.mesh import active_mesh
from . import transform as T

N_ATTEMPTS = 10  # rejection attempts of a random-resized crop
_F32 = torch.float32


def supports(transforms):
    """True when every transform in the list has a device implementation."""
    return all(isinstance(t, (T.RandomResizedCrop3D, T.RandomRotation3D,
                              T.RandomFlip3D, T.Resize3D))
               for t in transforms)


def _on(values, like, dtype=None):
    """``values`` (a host sequence or CPU tensor) as a tensor on ``like``'s
    device; to the card by a pinned, asynchronous copy (no host sync)."""
    t = torch.as_tensor(values, dtype=dtype)
    if like.device.type == "cpu":
        return t
    return t.pin_memory().to(like.device, non_blocking=True)


def _uniform(u, lo, hi):
    """Unit draws ``u`` (float32 in [0, 1)) mapped onto [lo, hi) as
    ``jax.random.uniform`` maps its own: ``max(lo, u * (hi - lo) + lo)``
    in float32."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def crop_params(u_vol, u_ratio, u_gate, perms, u_off, in_shape, scale,
                ratio):
    """The window of a random-resized crop from its draws: ``u_vol``,
    ``u_ratio``, ``u_gate`` float32 [N_ATTEMPTS] unit draws, ``perms`` int
    [N_ATTEMPTS, 3] axis permutations, ``u_off`` float32 [3]; ``in_shape``
    int [3] on the draws' device (or a host sequence for host draws).

    Each attempt proposes (d, h, w) = (round((v * r) ** (1/3)),
    round((v / r) ** (1/3)), W) for a volume fraction v of ``scale`` and
    an aspect r of ``ratio``, permuted where its gate is under 0.5; the
    first that fits is placed at ``floor(u_off * (shape - crop + 1))``.
    With none, the centred cube of the shortest side. Returns (start [3],
    crop [3]) int64 on the draws' device."""
    shape = (in_shape.long() if torch.is_tensor(in_shape)
             else _on(list(in_shape), u_vol, torch.long))
    shape_f = shape.to(_F32)
    tv = _uniform(u_vol, *scale) * (shape_f[0] * shape_f[1] * shape_f[2])
    ar = _uniform(u_ratio, *ratio)
    third = float(np.float32(1 / 3))
    d = torch.round((tv * ar) ** third)
    h = torch.round((tv / ar) ** third)
    w = shape_f[2].expand(N_ATTEMPTS)
    dhw = torch.stack([d, h, w], dim=1)
    identity = torch.arange(3, device=perms.device).expand(N_ATTEMPTS, 3)
    order = torch.where((u_gate < 0.5)[:, None], perms.long(), identity)
    dhw = torch.gather(dhw, 1, order).long()
    valid = (dhw <= shape).all(dim=1) & (dhw >= 1).all(dim=1)
    first = torch.argmax(valid.to(torch.uint8))  # the first that fits
    chosen = dhw.index_select(0, first.reshape(1))[0]
    start = torch.floor(u_off * (shape - chosen + 1).to(_F32)).long()
    side = shape.min()
    any_valid = valid.any()
    crop = torch.where(any_valid, chosen, side.expand(3))
    start = torch.where(any_valid, start, (shape - side) // 2)
    return start, crop


def nonzero_bbox(label):
    """(start [3], extent [3]) int64 of the label's nonzero bounding box;
    an all-zero label gives the whole volume (where the reference raises
    on an empty index list)."""
    nz = label != 0
    any_voxels = nz.any()
    starts, extents = [], []
    for ax in range(3):
        line = nz.any(dim=tuple(a for a in range(3) if a != ax))
        n = line.shape[0]
        idx = torch.arange(n, device=label.device)
        lo = torch.where(line, idx, n).min()
        hi = torch.where(line, idx, -1).max() + 1
        lo = torch.where(any_voxels, lo, 0)
        hi = torch.where(any_voxels, hi, n)
        starts.append(lo)
        extents.append(hi - lo)
    return torch.stack(starts), torch.stack(extents)


def pre_crop_params(u_size, u_off, size, scale, base, extent):
    """The pre-crop window from its draws (``u_size``, ``u_off`` float32
    [3] unit draws): a crop of ``round(uniform(scale) * size)`` per axis,
    at most ``extent``, placed at ``base + floor(u_off * (extent - crop +
    1))``. ``base`` and ``extent`` are int [3] on the draws' device: the
    label's bounding box, or zeros and the volume's shape. Returns (start
    [3], crop [3]) int64."""
    target = _on([float(s) for s in size], u_size, _F32)
    crop_size = torch.round(_uniform(u_size, *scale) * target).long()
    crop = torch.minimum(extent, crop_size)
    offset = torch.floor(u_off * (extent - crop + 1).to(_F32)).long()
    return base + offset, crop


def step_seed(seed, step):
    """A generator seed that is a function of (``seed``, ``step``) only."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1)[0])


class DeviceAugmentor:
    """Batched augmentation built from a transform list.

    ``aug(images, labels, generator)`` with [N, D, H, W] float images and
    [N, D, H, W] int labels on one device returns ([N, d, h, w, 1] float32
    images divided by their max, [N, d, h, w] int64 labels) on that
    device: the Compose contract in NDHWC. It is the train step's
    ``augment_fn``; ``generator`` is the state's, of which only the seed
    it was last given is read, so the draws of a call depend on (``seed``,
    that seed) only. :meth:`draw`, :meth:`params` and :meth:`apply` are
    its three stages.

    Under a mesh (``parallel.use_mesh``) ``images`` and ``labels`` are the
    rank's rows of the global batch, whole samples: every rank draws the
    global batch's parameters and applies its rows', and a rank of a space
    axis then keeps its H block of the result."""

    def __init__(self, transforms, seed=0):
        if not supports(transforms):
            raise ValueError(
                "DeviceAugmentor only supports RandomResizedCrop3D/"
                "RandomRotation3D/RandomFlip3D/Resize3D, got {}".format(
                    [type(t).__name__ for t in transforms]))
        self.transforms = list(transforms)
        self.seed = seed

    def draw(self, n, key):
        """Per sample, per transform, the host draws for the integer
        ``key``: a dict each (uniforms as float32 CPU tensors,
        permutations, the angle, the plane's and the flip axis's index,
        the flip's gate)."""
        gen = torch.Generator().manual_seed(step_seed(self.seed, key))

        def rand(*shape):
            return torch.rand(shape, generator=gen, dtype=_F32)

        def index(count):
            return int(torch.randint(count, (), generator=gen))

        out = []
        for _ in range(n):
            sample = []
            for t in self.transforms:
                d = {}
                if isinstance(t, T.RandomResizedCrop3D):
                    if t.pre_crop:
                        d.update(pre_size=rand(3), pre_off=rand(3))
                    d.update(vol=rand(N_ATTEMPTS), ratio=rand(N_ATTEMPTS),
                             gate=rand(N_ATTEMPTS),
                             perms=torch.stack([
                                 torch.randperm(3, generator=gen)
                                 for _ in range(N_ATTEMPTS)]),
                             off=rand(3))
                elif isinstance(t, T.RandomRotation3D):
                    d.update(angle=_uniform(rand(), *t.degrees).item(),
                             plane=index(len(t.rotate_planes)))
                elif isinstance(t, T.RandomFlip3D):
                    d.update(flip=bool(rand() < t.prob),
                             axis=index(len(self._flip_axes(t))))
                sample.append(d)
            out.append(sample)
        return out

    @staticmethod
    def _flip_axes(t):
        return (list(t.flip_axis) if isinstance(t.flip_axis, (list, tuple))
                else [t.flip_axis])

    def params(self, draws, shape, label=None):
        """One sample's parameters from its draws: per transform a crop
        window (start, crop), a rotation (angle, plane), a flip mask (three
        booleans) or None (Resize3D). ``shape`` is the raw volume's (D, H,
        W); a ``nonzero_mask`` pre-crop reads ``label``'s bounding box on
        its device, and its window stays there (int64 tensors); every
        other window comes back as host integers."""
        out = []
        for t, d in zip(self.transforms, draws):
            if isinstance(t, T.RandomResizedCrop3D):
                out.append(self._crop(t, d, shape, label))
            elif isinstance(t, T.RandomRotation3D):
                out.append((d["angle"], tuple(t.rotate_planes[d["plane"]])))
            elif isinstance(t, T.RandomFlip3D):
                axis = self._flip_axes(t)[d["axis"]]
                out.append(tuple(d["flip"] and a == axis for a in range(3)))
            else:
                out.append(None)
        return out

    @staticmethod
    def _crop(t, d, shape, label):
        keys = ("vol", "ratio", "gate", "perms", "off")
        if t.pre_crop and t.nonzero_mask:
            if label is None:
                raise ValueError("a nonzero_mask crop needs the label")
            base, extent = nonzero_bbox(label)
            d = {k: _on(v, label) for k, v in d.items()}
            pre_start, pre_crop = pre_crop_params(
                d["pre_size"], d["pre_off"], t.size, t.scale, base, extent)
            start, crop = crop_params(*(d[k] for k in keys), pre_crop,
                                      t.scale, t.ratio)
            return pre_start + start, crop
        shape = torch.tensor([int(s) for s in shape])
        pre_start = torch.zeros(3, dtype=torch.long)
        if t.pre_crop:
            pre_start, shape = pre_crop_params(
                d["pre_size"], d["pre_off"], t.size, t.scale, pre_start,
                shape)
        start, crop = crop_params(*(d[k] for k in keys), shape, t.scale,
                                  t.ratio)
        return (pre_start + start).tolist(), crop.tolist()  # CPU tensors

    def apply_one(self, img, label, params):
        """Apply one sample's parameters: ``img`` [D, H, W] float, ``label``
        [D, H, W] (or None) in its own dtype (an integer label is rounded
        after each interpolation, a float one is not). Returns ([d, h, w,
        1] float32 divided by its max, the label)."""
        img = img.to(_F32)
        for t, p in zip(self.transforms, params):
            if isinstance(t, T.RandomResizedCrop3D):
                img = resize.crop_resize3d(img, p[0], p[1], t.size,
                                           order=t.interpolation)
                if label is not None:
                    label = resize.crop_resize3d(label, p[0], p[1], t.size,
                                                 order=0)
            elif isinstance(t, T.RandomRotation3D):
                shear = max(abs(t.degrees[0]), abs(t.degrees[1])) <= 45
                rot = spatial.rotate3d_shear if shear else spatial.rotate3d
                img = rot(img, p[0], r_plane=p[1], order=1)
                if label is not None:
                    label = rot(label, p[0], r_plane=p[1], order=1)
            elif isinstance(t, T.RandomFlip3D):
                img = spatial.random_flip3d(img, p)
                if label is not None:
                    label = spatial.random_flip3d(label, p)
            else:
                size = t.size if isinstance(t.size, tuple) else (t.size,) * 3
                img = resize.resize3d(img, size, order=t.order)
                if label is not None:
                    label = resize.resize3d(label, size, order=0)
        return intensity.scale_by_max(img)[..., None], label

    def apply(self, images, labels, params):
        """Apply per-sample parameters (a list, one entry of
        :meth:`params` a sample) to a batch; labels come back int64."""
        labels = labels.long()
        outs = [self.apply_one(images[i], labels[i], p)
                for i, p in enumerate(params)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def __call__(self, images, labels, generator):
        n = images.shape[0]
        mesh = active_mesh()
        if mesh is None:
            draws = self.draw(n, generator.initial_seed())
        else:  # the global batch's draws; this rank's rows
            lo, hi = mesh.rows(n)
            draws = self.draw(n * mesh.data, generator.initial_seed())[lo:hi]
        params = [self.params(d, tuple(images.shape[1:4]), labels[i])
                  for i, d in enumerate(draws)]
        images, labels = self.apply(images, labels, params)
        if mesh is not None:  # whole samples augmented; this rank's H block
            images, labels = mesh.keep_h(images), mesh.keep_h(labels)
        return images, labels
