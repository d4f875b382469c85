"""The port's ingest path (medicalseg_torch.ops intensity / resize /
hu_resize, medicalseg_torch.io, utils.quant) against the JAX package: the
same numpy-seeded inputs go through the JAX function and its counterpart.

Tolerances: intensity ops 1e-6 (the same f32 arithmetic, elementwise);
order-1 resize 1e-4 on inputs of magnitude 1 (three contractions summed in
another order), order 0 and integer volumes exact; the fused HU window +
resize 1e-3 on its 0..255 scale, the JAX package's own tolerance for it
(tests/test_pallas_kernels.py); quantization bit for bit.
"""
import os
import struct

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu import io as jio
from medicalseg_tpu import ops as jops
from medicalseg_tpu.ops import resize as jresize
from medicalseg_tpu.utils import quant as jquant
from medicalseg_torch import io as tio
from medicalseg_torch import ops as tops
from medicalseg_torch.ops import hu_resize as thr
from medicalseg_torch.ops import resize as tresize
from medicalseg_torch.utils import quant as tquant
from medicalseg_torch.utils import transplant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw_ct(rng, shape, specials=True):
    x = rng.uniform(-2000, 1000, shape).astype(np.float32)
    if specials:
        flat = x.reshape(-1)
        flat[0], flat[flat.size // 2], flat[-1] = np.nan, np.inf, -np.inf
    return x


# ----------------------------------------------------------------------
# intensity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("window", [(-1200.0, 600.0, -2000.0),
                                    (-1000.0, 400.0, -300.0)])
def test_hu_norm_matches_jax(window):
    x = _raw_ct(np.random.RandomState(0), (6, 7, 9))
    got = tops.hu_norm(x, *window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.hu_norm(x, *window)),
                               atol=1e-6 * 255)
    ints = np.random.RandomState(1).randint(-2000, 1000, (4, 5, 6)).astype(
        np.int16)
    np.testing.assert_allclose(tops.hu_norm(ints).numpy(),
                               np.asarray(jops.hu_norm(ints)),
                               atol=1e-6 * 255)


@pytest.mark.parametrize("bounds", [None, (-100.0, 250.0)])
def test_normalize_matches_jax(bounds):
    x = np.random.RandomState(2).uniform(-500, 500, (5, 6, 7)).astype(
        np.float32)
    args = bounds or (None, None)
    np.testing.assert_allclose(tops.normalize(x, *args).numpy(),
                               np.asarray(jops.normalize(x, *args)),
                               atol=1e-6)


def test_label_remap_matches_jax():
    lab = np.random.RandomState(3).randint(0, 6, (4, 5, 6)).astype(np.int32)
    for mapping in ({1: 0, 2: 1, 5: 3}, {9: 2, 0: 4}, {}):
        got = tops.label_remap(lab, mapping)
        ref = np.asarray(jops.label_remap(lab, mapping))
        assert got.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(got.numpy(), ref)


def test_scale_by_max_matches_jax():
    rng = np.random.RandomState(4)
    for x in (rng.uniform(0, 255, (4, 4, 4)).astype(np.float32),
              -rng.uniform(0, 255, (4, 4, 4)).astype(np.float32),
              np.zeros((3, 3, 3), np.float32)):
        np.testing.assert_allclose(tops.scale_by_max(x).numpy(),
                                   np.asarray(jops.scale_by_max(x)),
                                   atol=1e-6)


# ----------------------------------------------------------------------
# resize
# ----------------------------------------------------------------------
RESIZE_SHAPES = [((16, 16, 16), (8, 8, 8)), ((9, 11, 13), (16, 16, 16)),
                 ((32, 32, 8), (16, 16, 16)), ((7, 7, 7), (7, 7, 7)),
                 ((5, 6, 7), (1, 6, 14)), ((12, 12, 12), (5, 7, 9)),
                 ((1, 4, 5), (3, 8, 5))]


@pytest.mark.parametrize("in_shape,out_shape", RESIZE_SHAPES)
def test_resize3d_order1_matches_jax(in_shape, out_shape):
    img = np.random.RandomState(0).rand(*in_shape).astype(np.float32)
    got = tops.resize3d(torch.from_numpy(img), out_shape, order=1)
    ref = np.asarray(jops.resize3d(jnp.asarray(img), out_shape, order=1))
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("in_shape,out_shape", RESIZE_SHAPES)
def test_resize3d_order0_matches_jax(in_shape, out_shape):
    lab = np.random.RandomState(1).randint(0, 5, in_shape).astype(np.int32)
    got = tops.resize3d(torch.from_numpy(lab), out_shape, order=0)
    ref = np.asarray(jops.resize3d(jnp.asarray(lab), out_shape, order=0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("order", [0, 1])
def test_resize3d_channel_last_4d_matches_jax(order):
    img = np.random.RandomState(2).rand(8, 6, 7, 3).astype(np.float32)
    got = tops.resize3d(img, (12, 9, 5), order=order)
    ref = np.asarray(jops.resize3d(jnp.asarray(img), (12, 9, 5),
                                   order=order))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * order)
    with pytest.raises(ValueError):
        tops.resize3d(np.zeros((4, 4)), (2, 2, 2))


def test_resize3d_integer_volume_rounds_and_keeps_dtype():
    vol = np.random.RandomState(3).randint(-1000, 1000, (9, 10, 11)).astype(
        np.int16)
    got = tops.resize3d(torch.from_numpy(vol), (6, 14, 11), order=1)
    ref = np.asarray(jops.resize3d(jnp.asarray(vol), (6, 14, 11), order=1))
    assert got.dtype == torch.int16 and ref.dtype == np.int16
    # a value that lands within f32 rounding of .5 may round either way
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3


def test_resize3d_batch_and_resize_to_spacing_match_jax():
    rng = np.random.RandomState(5)
    batch = rng.rand(2, 6, 7, 8, 2).astype(np.float32)
    np.testing.assert_allclose(
        tops.resize3d_batch(torch.from_numpy(batch), (4, 9, 8)).numpy(),
        np.asarray(jops.resize3d_batch(jnp.asarray(batch), (4, 9, 8))),
        atol=1e-4)
    img = rng.rand(20, 30, 30).astype(np.float32)
    for kwargs in (dict(new_spacing=(2.0, 2.0, 5.0)),
                   dict(new_shape=(16, 16, 16))):
        got, sp = tops.resize_to_spacing(torch.from_numpy(img),
                                         spacing=(1.0, 1.0, 2.5), **kwargs)
        ref, jsp = jops.resize_to_spacing(jnp.asarray(img),
                                          spacing=(1.0, 1.0, 2.5), **kwargs)
        np.testing.assert_allclose(sp, jsp)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    with pytest.raises(ValueError):
        tops.resize_to_spacing(torch.from_numpy(img), (1, 1, 1))


@pytest.mark.parametrize("in_size,out_size", [(200, 128), (37, 16), (1, 5),
                                              (9, 1), (16, 16), (10, 40),
                                              (2, 3)])
def test_linear_taps_equal_the_dense_matrix_rows(in_size, out_size):
    """The (lo, hi, w0, w1) vectors the kernel is given rebuild the JAX
    package's dense matrix bit for bit; the port's dense matrix equals it
    too, and the nearest indices agree."""
    dense = np.asarray(jresize._linear_matrix(in_size, out_size))
    np.testing.assert_array_equal(
        tresize._linear_matrix(in_size, out_size).numpy(), dense)
    idx, wt = thr.linear_taps_d(in_size, out_size)
    assert idx.dtype == np.int32 and wt.dtype == np.float32
    assert idx.min() >= 0 and idx.max() < in_size
    rebuilt = np.zeros_like(dense)
    rows = np.arange(out_size)
    rebuilt[rows, idx[0]] = wt[0]
    rebuilt[rows, idx[1]] += wt[1]
    np.testing.assert_array_equal(rebuilt, dense)
    np.testing.assert_array_equal(
        tresize._nearest_indices(in_size, out_size).numpy(),
        np.asarray(jresize._nearest_indices(in_size, out_size)))


# ----------------------------------------------------------------------
# fused HU window + resize
# ----------------------------------------------------------------------
HU_CASES = {"down": ((24, 16, 16), (12, 8, 8)),
            "odd_hw": ((37, 9, 11), (16, 8, 8)),
            "d_is_1": ((1, 7, 9), (5, 7, 9)),
            "out_d_is_1": ((9, 5, 3), (1, 5, 3)),
            "same_d": ((16, 16, 16), (16, 8, 8)),
            "up": ((10, 8, 8), (40, 12, 12))}


@pytest.mark.parametrize("mode", ["interpret", "disabled"])
@pytest.mark.parametrize("case", sorted(HU_CASES))
def test_hu_norm_resize_matches_jax(monkeypatch, case, mode):
    """Against the JAX function run both ways its own tests run it: the
    Pallas kernel in interpret mode, and the composition it falls back
    to. Inputs hold NaN and both infinities."""
    monkeypatch.setenv("MEDSEG_PALLAS_INTERPRET" if mode == "interpret"
                       else "MEDSEG_DISABLE_PALLAS", "1")
    from medicalseg_tpu.ops import pallas_kernels
    assert pallas_kernels._pallas_enabled() == (mode == "interpret")
    in_shape, size = HU_CASES[case]
    raw = _raw_ct(np.random.RandomState(0), in_shape)
    ref = np.asarray(jops.hu_norm_resize(jnp.asarray(raw), size))
    before = thr.LAUNCHES["hu_resize"]
    got = tops.hu_norm_resize(torch.from_numpy(raw), size)
    assert thr.LAUNCHES["hu_resize"] == before  # CPU: the plain version
    assert tuple(got.shape) == size and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    comp = tops.resize3d(tops.hu_norm(raw), size, order=1)
    np.testing.assert_allclose(got.numpy(), comp.numpy(), atol=1e-3)


def test_hu_norm_resize_window_arguments_and_input_forms(monkeypatch):
    """A hu_nan inside the window must show in the result (a clip written
    with min/max alone would turn NaN into 0); int16, non-contiguous and
    4-D inputs are taken."""
    monkeypatch.setenv("MEDSEG_DISABLE_PALLAS", "1")
    raw = _raw_ct(np.random.RandomState(1), (12, 10, 6), specials=False)
    raw[::2, 3, 2] = np.nan
    window = (-1000.0, 400.0, -300.0)
    ref = np.asarray(jops.hu_norm_resize(jnp.asarray(raw), (8, 5, 6),
                                         *window))
    got = tops.hu_norm_resize(raw, (8, 5, 6), *window)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    zeroed = tops.hu_norm_resize(np.nan_to_num(raw, nan=-5000.0), (8, 5, 6),
                                 *window)
    # the NaN voxels sit at 127.5 before the H and W passes spread them
    assert (got - zeroed).abs().max() > 10

    ints = np.nan_to_num(raw[:, :, :4]).astype(np.int16)
    ref = np.asarray(jops.hu_norm_resize(jnp.asarray(ints), (5, 5, 4)))
    np.testing.assert_allclose(
        tops.hu_norm_resize(torch.from_numpy(ints), (5, 5, 4)).numpy(), ref,
        atol=1e-3)
    strided = torch.from_numpy(np.nan_to_num(raw)).permute(2, 0, 1)
    assert not strided.is_contiguous()
    ref = np.asarray(jops.hu_norm_resize(
        jnp.asarray(strided.contiguous().numpy()), (4, 6, 5)))
    np.testing.assert_allclose(
        tops.hu_norm_resize(strided, (4, 6, 5)).numpy(), ref, atol=1e-3)
    vol4 = _raw_ct(np.random.RandomState(2), (6, 5, 4, 2))
    ref = np.asarray(jops.hu_norm_resize(jnp.asarray(vol4), (3, 5, 8)))
    np.testing.assert_allclose(
        tops.hu_norm_resize(vol4, (3, 5, 8)).numpy(), ref, atol=1e-3)
    with pytest.raises(ValueError):
        thr.hu_resize_d(torch.zeros(4, 4), 2)
    with pytest.raises(ValueError):
        thr.hu_resize_d(torch.zeros(4, 4, 4), 0)


# ----------------------------------------------------------------------
# readers
# ----------------------------------------------------------------------
def _assert_meta_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(val, np.float64), err_msg=key)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz", ".mha", ".mhd",
                                    ".nrrd", ".npy"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_readers_cross_read_the_jax_package(tmp_path, suffix, dtype):
    """A file written by either package's ``write_image`` reads back equal
    (data, dtype and meta) through both packages' ``read_image``."""
    vol = np.random.RandomState(7).uniform(-1000, 1000, (5, 6, 7)).astype(
        dtype)
    geom = dict(spacing=(0.7, 0.8, 2.5), origin=(1.0, -2.0, 3.0))
    for writer, name in ((jio, "j"), (tio, "t")):
        path = str(tmp_path / (name + suffix))
        writer.write_image(path, vol, **geom)
        jdata, jmeta = jio.read_image(path)
        tdata, tmeta = tio.read_image(path)
        assert tdata.dtype == jdata.dtype == vol.dtype
        np.testing.assert_array_equal(tdata, jdata)
        np.testing.assert_array_equal(tdata, vol)
        _assert_meta_equal(tmeta, jmeta)
    files = sorted(os.listdir(str(tmp_path)))
    pairs = [(a, b) for a in files for b in files
             if a[0] == "j" and b[0] == "t" and a[1:] == b[1:]]
    assert pairs
    for a, b in pairs:  # both writers produce the same bytes
        ja = (tmp_path / a).read_bytes()
        tb = (tmp_path / b).read_bytes()
        if suffix == ".mhd":  # the header names its own .raw file
            ja, tb = ja.replace(b"j.", b"x."), tb.replace(b"t.", b"x.")
        if not suffix.endswith(".gz"):  # gzip stamps a time and a name
            assert ja == tb


def _write_fake_dicom(path, pixels, instance, pos):
    """Minimal explicit-VR little-endian DICOM slice."""
    def elem(group, el, vr, value):
        head = struct.pack("<HH", group, el) + vr
        if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
            return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    rows, cols = pixels.shape
    body = b"".join([
        elem(0x0018, 0x0050, b"DS", b"2.5 "),
        elem(0x0020, 0x0013, b"IS", str(instance).encode()),
        elem(0x0020, 0x0032, b"DS", "\\".join(str(p) for p in pos).encode()),
        elem(0x0020, 0x0037, b"DS", b"1\\0\\0\\0\\1\\0"),
        elem(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        elem(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        elem(0x0028, 0x0030, b"DS", b"0.7\\0.7 "),
        elem(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        elem(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
        elem(0x7FE0, 0x0010, b"OW", pixels.astype("<i2").tobytes())])
    meta = elem(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1\x00")
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def test_dicom_series_and_slice_match_the_jax_package(tmp_path):
    rng = np.random.RandomState(5)
    slices = [rng.randint(-500, 500, (8, 8)).astype(np.int16)
              for _ in range(3)]
    for i in (2, 0, 1):  # written out of order: sorted by position
        _write_fake_dicom(str(tmp_path / "s{}.dcm".format(i)), slices[i],
                          instance=i + 1, pos=(0.0, 0.0, 2.5 * i))
    tdata, tmeta = tio.read_image(str(tmp_path))
    jdata, jmeta = jio.read_image(str(tmp_path))
    assert tdata.shape == (3, 8, 8)
    np.testing.assert_array_equal(tdata, jdata)
    np.testing.assert_array_equal(tdata, np.stack(slices))
    _assert_meta_equal(tmeta, jmeta)
    one = str(tmp_path / "s1.dcm")
    tdata, tmeta = tio.read_image(one)
    jdata, jmeta = jio.read_image(one)
    np.testing.assert_array_equal(tdata, jdata)
    _assert_meta_equal(tmeta, jmeta)


def test_read_image_rejects_what_the_jax_package_rejects(tmp_path):
    assert tio.SUPPORTED_SUFFIXES == jio.SUPPORTED_SUFFIXES
    for reader in (tio, jio):
        with pytest.raises(ValueError):
            reader.read_image(str(tmp_path / "x.unknown"))
        with pytest.raises(RuntimeError):
            reader.read_image(str(tmp_path / "x.raw"))
        with pytest.raises(ValueError):
            reader.write_image(str(tmp_path / "x.unknown"), np.zeros((2,) * 3))


# ----------------------------------------------------------------------
# int8 weights
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def vnet_variables():
    from medicalseg_tpu.models import VNet as JVNet
    model = JVNet(in_channels=1, num_classes=3)
    variables = jax.jit(lambda k, a: model.init(k, a, train=False))(
        jax.random.PRNGKey(11), jnp.zeros((1, 16, 16, 16, 1)))
    return jax.device_get(flax.core.unfreeze(variables))


def _quant_leaves(tree, path=()):
    if isinstance(tree, dict) and jquant.QUANT_KEY in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _quant_leaves(v, path + (k,))


def test_quantize_state_dict_is_bit_exact_with_the_jax_tree(vnet_variables):
    """quantize(transplant(tree)) == transplant(quantize(tree)), q and
    scale bit for bit, for every tensor either side quantizes; and the
    transplant of the quantized tree goes back unchanged."""
    from medicalseg_torch.models import VNet
    jq = jax.device_get(jquant.quantize_tree(vnet_variables))
    moved = transplant.state_dict_from_flax(jq)
    transposed = tquant.transposed_conv_weights(VNet(num_classes=3))
    assert len(transposed) == 4
    tq = tquant.quantize_state_dict(
        transplant.state_dict_from_flax(vnet_variables), transposed)
    assert list(tq) == list(moved)
    n_quant = 0
    for name, t in moved.items():
        assert tq[name].dtype == t.dtype and tq[name].shape == t.shape, name
        assert torch.equal(tq[name], t), name
        n_quant += name.endswith(tquant.QUANT_SUFFIX)
    assert n_quant == len(list(_quant_leaves(jq))) == 24
    # the 1^3 head (27 values) and every 1-D leaf stay float32
    assert tq["out_tr.conv2.weight"].dtype == torch.float32
    assert tq["in_tr.conv1.weight.__quant__"].dtype == torch.int8
    back = transplant.flax_from_state_dict(tq)
    for path, leaf in _quant_leaves(jq):
        got = back
        for key in path:
            got = got[key]
        np.testing.assert_array_equal(got[jquant.QUANT_KEY],
                                      np.asarray(leaf[jquant.QUANT_KEY]))
        assert got[jquant.QUANT_KEY].dtype == np.int8
        np.testing.assert_array_equal(got["scale"], np.asarray(leaf["scale"]))


def test_dequantized_weights_are_within_half_a_step(vnet_variables):
    from medicalseg_torch.models import VNet
    state = transplant.state_dict_from_flax(vnet_variables)
    transposed = tquant.transposed_conv_weights(VNet(num_classes=3))
    tq = tquant.quantize_state_dict(state, transposed)
    deq = tquant.dequantize_state_dict(tq, transposed)
    assert list(deq) == list(state)
    jdeq = transplant.state_dict_from_flax(jax.device_get(
        jquant.dequantize_tree(jquant.quantize_tree(vnet_variables))))
    for name, w in state.items():
        assert deq[name].dtype == torch.float32
        assert torch.equal(deq[name], jdeq[name]), name
        if name + tquant.QUANT_SUFFIX not in tq:
            assert torch.equal(deq[name], w)
            continue
        axis = 1 if name in transposed else 0
        scale = tq[name + tquant.SCALE_SUFFIX]
        shape = [1] * w.ndim
        shape[axis] = -1
        assert ((deq[name] - w).abs() <=
                scale.reshape(shape) / 2 + 1e-7).all(), name  # + f32 rounding
    small = tquant.quantize_state_dict({"w": torch.randn(4, 4, 4)},
                                       min_size=64)
    assert sorted(small) == ["w.__quant__", "w.scale"]
    assert tquant.dequantize_state_dict(small, dtype=torch.bfloat16)[
        "w"].dtype == torch.bfloat16
