"""The port's device augmentation (medicalseg_torch.transforms.device)
against the JAX package's on the CPU.

The two packages draw from different generators, so the sampler is held
to the JAX one on the JAX draws: the uniform draws (and permutations,
indices) that ``jax.random`` makes from one key are fed to the port's
pure functions, which must return what ``_sample_crop_params``,
``_sample_pre_crop`` and ``_nonzero_bbox`` return for that key, exactly.
The apply step is held to ``DeviceAugmentor._augment_one`` of the JAX
package at the parameters its key draws, for the flagship recipe
(RandomRotation3D(30) + RandomFlip3D at the spine geometry (8, 32, 32))
and the lung recipe (RandomResizedCrop3D + RandomRotation3D(90) +
RandomFlip3D, its crop size cut from 128 to 16 with the volumes):
images at atol 1e-5, labels equal except at .5 ties of the JAX value
before rounding (within 1e-4).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.transforms import device as jdevice
from medicalseg_tpu.transforms import transform as JT
from medicalseg_torch.transforms import device as tdevice
from medicalseg_torch.transforms import transform as TT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _crop_draws(key):
    """The draws of ``_sample_crop_params(key, ...)``, as torch tensors."""
    kd, kv, ka, kp, ko = jax.random.split(key, 5)
    n = tdevice.N_ATTEMPTS
    perms = jax.vmap(lambda k: jax.random.permutation(k, 3))(
        jax.random.split(kd, n))
    return [torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(kv, (n,)), jax.random.uniform(ka, (n,)),
        jax.random.uniform(kp, (n,)), perms, jax.random.uniform(ko, (3,)))]


def _pre_crop_draws(key):
    ku, ko = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.uniform(k, (3,))))
            for k in (ku, ko)]


def _as_np(pair):
    return [np.asarray(x) for x in pair]


@pytest.mark.parametrize("in_shape,scale,ratio", [
    ((8, 32, 32), (0.8, 1.2), (3 / 4, 4 / 3)),
    ((16, 16, 16), (0.5, 1.0), (3 / 4, 4 / 3)),
    ((128, 128, 128), (0.8, 1.2), (3 / 4, 4 / 3)),
    ((8, 32, 32), (3.0, 4.0), (3 / 4, 4 / 3)),  # nothing fits: the cube
])
@pytest.mark.parametrize("seed", range(6))
def test_crop_sampler_on_jax_draws(in_shape, scale, ratio, seed):
    key = jax.random.PRNGKey(seed)
    ref = _as_np(jdevice._sample_crop_params(key, in_shape, scale, ratio))
    got = tdevice.crop_params(*_crop_draws(key), in_shape, scale, ratio)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    if scale[0] > 2:
        assert list(got[1]) == [min(in_shape)] * 3


def _bbox_label(kind):
    lab = np.zeros((8, 32, 32), np.int32)
    if kind == "box":
        lab[2:6, 5:20, 11:30] = 3
        lab[3, 25, 1] = 1
    return lab


@pytest.mark.parametrize("kind", ["box", "empty"])
def test_nonzero_bbox_matches_jax(kind):
    lab = _bbox_label(kind)
    ref = _as_np(jdevice._nonzero_bbox(jnp.asarray(lab)))
    got = tdevice.nonzero_bbox(torch.from_numpy(lab))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    if kind == "empty":  # the whole volume (the reference would raise)
        assert got[0].tolist() == [0, 0, 0]
        assert got[1].tolist() == [8, 32, 32]


@pytest.mark.parametrize("nonzero_mask", [False, True])
@pytest.mark.parametrize("kind", ["box", "empty"])
@pytest.mark.parametrize("seed", range(4))
def test_pre_crop_sampler_on_jax_draws(nonzero_mask, kind, seed):
    """``_sample_pre_crop`` and the two-stage window of ``_apply_crop``:
    the random-resized window drawn inside the (traced) pre-crop extent,
    offset back into the volume."""
    lab = _bbox_label(kind)
    jt = JT.RandomResizedCrop3D(size=(6, 16, 16), scale=(0.8, 1.2),
                                pre_crop=True, nonzero_mask=nonzero_mask)
    key = jax.random.PRNGKey(100 + seed)
    kp, kc = jax.random.split(key)
    ref_pre = _as_np(jdevice._sample_pre_crop(jt, kp, lab.shape,
                                              jnp.asarray(lab)))
    ref = _as_np(jdevice._sample_crop_params(
        kc, jnp.asarray(ref_pre[1]), jt.scale, jt.ratio))

    if nonzero_mask:
        base, extent = tdevice.nonzero_bbox(torch.from_numpy(lab))
    else:
        base, extent = torch.zeros(3, dtype=torch.long), torch.tensor(
            lab.shape)
    pre = tdevice.pre_crop_params(*_pre_crop_draws(kp), jt.size, jt.scale,
                                  base, extent)
    for a, b in zip(pre, ref_pre):
        np.testing.assert_array_equal(a.numpy(), b)
    got = tdevice.crop_params(*_crop_draws(kc), pre[1], jt.scale, jt.ratio)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def _recipe(which, mod):
    if which == "flagship":  # configs/synthetic/vnetdeepsup_synspine_15k.yml
        return [mod.RandomRotation3D(degrees=30), mod.RandomFlip3D()]
    # configs/lung_coronavirus/lung_coronavirus.yml, the crop size 128 -> 16
    return [mod.RandomResizedCrop3D(size=16, scale=[0.8, 1.2]),
            mod.RandomRotation3D(degrees=90), mod.RandomFlip3D()]


def _jax_params(transforms, key, shape):
    """The parameters ``_augment_one`` draws from ``key`` for one sample,
    in the port's form."""
    keys = jax.random.split(key, len(transforms))
    out = []
    for t, k in zip(transforms, keys):
        if isinstance(t, JT.RandomResizedCrop3D):
            start, crop = jdevice._sample_crop_params(k, shape, t.scale,
                                                      t.ratio)
            out.append((np.asarray(start).tolist(),
                        np.asarray(crop).tolist()))
        elif isinstance(t, JT.RandomRotation3D):
            ka, kp = jax.random.split(k)
            angle = float(jax.random.uniform(ka, (), minval=t.degrees[0],
                                             maxval=t.degrees[1]))
            idx = int(jax.random.randint(kp, (), 0, len(t.rotate_planes)))
            out.append((angle, tuple(t.rotate_planes[idx])))
        else:
            kp, ka = jax.random.split(k)
            flip = bool(jax.random.bernoulli(kp, t.prob))
            axis = t.flip_axis[int(jax.random.randint(
                ka, (), 0, len(t.flip_axis)))]
            out.append(tuple(flip and a == axis for a in range(3)))
    return out


@pytest.mark.parametrize("which,shape", [("flagship", (8, 32, 32)),
                                         ("lung", (12, 12, 12))])
@pytest.mark.parametrize("seed", range(4))
def test_apply_matches_jax_augment_one(which, shape, seed):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*shape) * 255).astype(np.float32)
    lab = rng.randint(0, 20, shape).astype(np.int32)
    jaug = jdevice.DeviceAugmentor(_recipe(which, JT))
    key = jax.random.PRNGKey(seed)
    ref_img, ref_lab = _as_np(jaug._augment_one(jnp.asarray(img),
                                                jnp.asarray(lab), key))
    pre_img, pre_lab = _as_np(jaug._augment_one(
        jnp.asarray(img), jnp.asarray(lab.astype(np.float32)), key))

    aug = tdevice.DeviceAugmentor(_recipe(which, TT))
    params = _jax_params(jaug.transforms, key, shape)
    got_img, got_lab = aug.apply_one(torch.from_numpy(img),
                                     torch.from_numpy(lab).long(), params)
    assert got_img.shape == ref_img.shape and got_img.dtype == torch.float32
    assert got_lab.dtype == torch.int64
    np.testing.assert_allclose(got_img.numpy(), ref_img, atol=1e-5, rtol=0)
    tie = np.abs(pre_lab - np.floor(pre_lab) - 0.5) < 1e-4
    np.testing.assert_array_equal(got_lab.numpy()[~tie], ref_lab[~tie])


def test_draws_depend_on_the_seeds_only():
    """The draws of a call are a function of the augmentor's seed and the
    seed of the generator it is handed (the train loop seeds that one from
    (seed, step)), not of the generator's state."""
    aug = tdevice.DeviceAugmentor(_recipe("lung", TT), seed=5)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(3, 12, 12, 12).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, (3, 12, 12, 12)))
    gen = torch.Generator().manual_seed(7)
    a = aug(images, labels, gen)
    torch.rand(5, generator=gen)  # the state's generator moves on
    b = tdevice.DeviceAugmentor(_recipe("lung", TT), seed=5)(images, labels,
                                                            gen)
    c = aug(images, labels, torch.Generator().manual_seed(8))
    assert a[0].shape == (3, 16, 16, 16, 1) and a[1].shape == (3, 16, 16, 16)
    assert a[1].dtype == torch.int64
    assert float(a[0].max()) <= 1.0 and float(a[0].min()) >= 0.0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # each sample draws its own parameters
    draws = aug.draw(3, 7)
    assert draws[0][1]["angle"] != draws[1][1]["angle"]


def test_nonzero_mask_window_stays_on_the_labels_device():
    """A nonzero_mask pre-crop's window is computed from the label where it
    lies (tensors), every other window comes back as host integers."""
    t = TT.RandomResizedCrop3D(size=(6, 16, 16), pre_crop=True,
                               nonzero_mask=True)
    aug = tdevice.DeviceAugmentor([t, TT.RandomFlip3D()])
    lab = torch.from_numpy(_bbox_label("box"))
    (start, crop), _ = aug.params(aug.draw(1, 0)[0], (8, 32, 32), lab)
    assert torch.is_tensor(start) and torch.is_tensor(crop)
    assert all(0 <= int(s) and int(s) + int(c) <= n
               for s, c, n in zip(start, crop, (8, 32, 32)))
    plain = tdevice.DeviceAugmentor([TT.RandomResizedCrop3D(size=8)])
    (start, crop), = plain.params(plain.draw(1, 0)[0], (8, 32, 32))
    assert isinstance(start, list) and isinstance(crop[0], int)


def test_supports():
    assert tdevice.supports([TT.RandomFlip3D(), TT.Resize3D(8)])
    assert not tdevice.supports([TT.BinaryMaskToConnectComponent()])
    with pytest.raises(ValueError, match="only supports"):
        tdevice.DeviceAugmentor([TT.TopkLargestConnectComponent()])
