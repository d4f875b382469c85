"""The port's spatial ops (medicalseg_torch.ops.spatial, crop_resize3d of
medicalseg_torch.ops.resize) against the JAX package's on the CPU, at the
spine geometry (8, 32, 32), inputs from numpy with a seed.

Tolerances: float32 volumes atol 1e-5 (both sides compute every
coordinate in float32 in the same order; they differ by the last bits of
the trigonometric functions and of the summation); integer labels equal,
except for the shear rotation where the JAX value before rounding lies
within 1e-4 of a .5 tie (there a last-bit difference may round the other
way); flips and order-0 resizes exactly; order-1 crops at 1e-5.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalseg_tpu.ops import resize as jresize
from medicalseg_tpu.ops import spatial as jspatial
from medicalseg_torch.ops import resize as tresize
from medicalseg_torch.ops import spatial as tspatial

SHAPE = (8, 32, 32)
PLANES = [(0, 1), (0, 2), (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _volumes(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*SHAPE).astype(np.float32),
            rng.randint(0, 20, SHAPE).astype(np.int32))


def _labels_agree(jax_fn, port_fn, lab):
    """Port labels equal the JAX ones except at .5 ties of the JAX
    float32 value; returns the number of voxels compared."""
    ref = np.asarray(jax_fn(jnp.asarray(lab)))
    pre = np.asarray(jax_fn(jnp.asarray(lab.astype(np.float32))))
    got = port_fn(torch.from_numpy(lab).long()).numpy()
    tie = np.abs(pre - np.floor(pre) - 0.5) < 1e-4
    np.testing.assert_array_equal(got[~tie], ref[~tie])
    return int((~tie).sum())


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("angle", [-29.5, 17.0, 44.0])
def test_rotate3d_shear_matches_jax(plane, angle):
    vol, lab = _volumes()
    ref = np.asarray(jspatial.rotate3d_shear(jnp.asarray(vol), angle,
                                             r_plane=plane))
    got = tspatial.rotate3d_shear(torch.from_numpy(vol), angle,
                                  r_plane=plane).numpy()
    assert got.shape == SHAPE and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert (got == 0).any() and (got != 0).mean() > 0.1  # corners leave
    n = _labels_agree(
        lambda x: jspatial.rotate3d_shear(x, angle, r_plane=plane),
        lambda x: tspatial.rotate3d_shear(x, angle, r_plane=plane), lab)
    assert n > 0.99 * lab.size


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("angle", [-37.5, 90.0])
@pytest.mark.parametrize("order", [0, 1])
def test_rotate3d_matches_jax(plane, angle, order):
    vol, lab = _volumes(1)
    ref = np.asarray(jspatial.rotate3d(jnp.asarray(vol), angle,
                                       r_plane=plane, order=order))
    got = tspatial.rotate3d(torch.from_numpy(vol), angle, r_plane=plane,
                            order=order).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    ref = np.asarray(jspatial.rotate3d(jnp.asarray(lab), angle,
                                       r_plane=plane, order=order))
    got = tspatial.rotate3d(torch.from_numpy(lab).long(), angle,
                            r_plane=plane, order=order)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rot", ["rotate3d", "rotate3d_shear"])
def test_rotations_of_a_trailing_channel_axis(rot):
    """4-D [D, H, W, C] volumes rotate each channel alike."""
    rng = np.random.RandomState(2)
    vol = rng.rand(*SHAPE, 2).astype(np.float32)
    ref = np.asarray(getattr(jspatial, rot)(jnp.asarray(vol), 21.0,
                                            r_plane=(1, 2)))
    got = getattr(tspatial, rot)(torch.from_numpy(vol), 21.0,
                                 r_plane=(1, 2)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mask", [(False, False, False), (True, False, False),
                                  (False, True, True), (True, True, True)])
def test_random_flip3d_matches_jax(mask):
    vol, lab = _volumes(3)
    for arr in (vol, lab):
        ref = np.asarray(jspatial.random_flip3d(jnp.asarray(arr),
                                                jnp.asarray(mask)))
        got = tspatial.random_flip3d(torch.from_numpy(arr), mask).numpy()
        np.testing.assert_array_equal(got, ref)


def test_flip3d_and_crop3d_match_jax():
    vol, _ = _volumes(4)
    t = torch.from_numpy(vol)
    for axis in range(3):
        np.testing.assert_array_equal(
            tspatial.flip3d(t, axis).numpy(),
            np.asarray(jspatial.flip3d(jnp.asarray(vol), axis)))
    np.testing.assert_array_equal(
        tspatial.crop3d(t, 1, 2, 3, 5, 20, 9).numpy(),
        np.asarray(jspatial.crop3d(jnp.asarray(vol), 1, 2, 3, 5, 20, 9)))


CROPS = [((1, 2, 0), (6, 27, 32), (8, 24, 24)),
         ((0, 0, 0), (8, 32, 32), (12, 40, 36)),
         ((3, 5, 7), (5, 20, 25), (1, 16, 16)),
         ((2, 0, 4), (6, 30, 27), (8, 32, 32))]


@pytest.mark.parametrize("start,crop,size", CROPS)
@pytest.mark.parametrize("order", [0, 1])
def test_crop_resize3d_matches_jax(start, crop, size, order):
    vol, lab = _volumes(5)
    for arr in (vol, lab):
        ref = np.asarray(jresize.crop_resize3d(
            jnp.asarray(arr), jnp.asarray(start), jnp.asarray(crop), size,
            order=order))
        got = tresize.crop_resize3d(torch.from_numpy(arr), start, crop, size,
                                    order=order).numpy()
        assert got.shape == size and got.dtype == arr.dtype
        if order == 0 or arr is lab:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("start,crop,size", CROPS)
def test_crop_geometry_as_tensors_matches_host_integers(start, crop, size):
    """The window given as 0-d integer tensors (as a crop drawn on the card
    arrives) builds the same matrices and indices as host integers."""
    for axis in range(3):
        args = (SHAPE[axis], start[axis], crop[axis], size[axis])
        targs = (SHAPE[axis], torch.tensor(start[axis]),
                 torch.tensor(crop[axis]), size[axis])
        np.testing.assert_array_equal(
            tresize._dynamic_linear_matrix(*targs).numpy(),
            tresize._dynamic_linear_matrix(*args).numpy())
        np.testing.assert_array_equal(
            tresize._dynamic_nearest_indices(*targs).numpy(),
            tresize._dynamic_nearest_indices(*args).numpy())
        np.testing.assert_allclose(
            tresize._dynamic_linear_matrix(*args).numpy(),
            np.asarray(jresize._dynamic_linear_matrix(
                args[0], jnp.asarray(args[1]), jnp.asarray(args[2]),
                args[3], jnp.float32)), atol=0, rtol=0)
