"""The port's native volume reader (``medicalseg_torch.data_native`` over
``csrc/medloader.cpp``, built by ``ops/_build.build_host``) against the
JAX package's binding (``medicalseg_tpu.data_native`` over
``native/medloader.cpp``) on the CPU.

The two libraries are built from the same C++ code with the same flags, so
every entry point is held to the JAX binding bit for bit: the gzip inflate,
the fused HU window + resize (f32 / int16 input, f32 / bf16 / uint8 out,
window on and off), the one-shot NIfTI ingest, and the volume loader over
``.npy`` files of every dtype it reads in both header versions. So are the
loader's batches in ``device`` and ``device_cache`` modes over two epochs
against the JAX loader's (which reads through its native binding in those
modes), and ``io.nifti.read`` of a ``.nii.gz``. The fused resize is held to
the port's plain ``ops.hu_resize.hu_norm_resize`` within ``HU_TOL`` on the
window's 0..255 scale: the two sum the same taps in float32 in another
order (and ``-march=native`` may contract a product and a sum into one
FMA), a few ulp at 255. Then the build itself: its ladder, the compiler's
error where no rung builds, and two builds at once. Shapes are small; the
whole file takes a few seconds once the library is built (~4 s).
"""
import gzip
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from medicalseg_tpu import data_native as jnative
from medicalseg_tpu.core import loader as jloader
from medicalseg_tpu.datasets import MedicalDataset as JMedicalDataset
from medicalseg_tpu.io import nifti as jnifti
from medicalseg_tpu.transforms import RandomFlip3D as JRandomFlip3D
from medicalseg_torch import data_native as tnative
from medicalseg_torch import io as medio
from medicalseg_torch.core import loader as tloader
from medicalseg_torch.datasets import MedicalDataset
from medicalseg_torch.io import nifti as tnifti
from medicalseg_torch.ops import _build
from medicalseg_torch.ops import hu_resize as hr
from medicalseg_torch.transforms import RandomFlip3D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HU_TOL = 1e-3  # native fused resize vs the plain torch one, 0..255 scale
DESCRS = ("<f4", "<i4", "<i2", "|u1", "<f8", "<i8")
OUT_DTYPES = ("float32", "bfloat16", "uint8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x):
    """A result of either binding as comparable numpy bits (bf16 as its
    uint16 words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _ct(shape, dtype, seed):
    """Seeded CT-like values in [-2000, 1000]; float32 with a few NaN."""
    rng = np.random.RandomState(seed)
    vol = (rng.rand(*shape) * 3000.0 - 2000.0).astype(dtype)
    if dtype == np.float32:
        vol.reshape(-1)[::97] = np.nan
    return vol


# --------------------------------------------------------------------------
# the library and its build
# --------------------------------------------------------------------------
def test_library_builds_under_build_dir_and_names_its_rung():
    path, rung = _build.build_host("medloader")
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libmedloader-{}-".format(rung))
    assert rung in [r for r, _, _ in _build.HOST_LADDER]
    assert tnative.backend() == rung.split("-")[0]
    assert tnative.backend() in ("libdeflate", "zlib", "none")
    assert not str(path).startswith(os.path.join(ROOT, "native") + os.sep)


def test_importing_the_reader_and_its_users_builds_nothing():
    code = ("import medicalseg_torch.data_native as d\n"
            "import medicalseg_torch.core.loader, medicalseg_torch.io\n"
            "assert d._loaded.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _isolated_build(monkeypatch, tmp_path, ladder=None, source=None):
    """Point the host build at ``tmp_path`` (and, given, another ladder or
    C++ source) with the loaded library forgotten; restored after."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if ladder is not None:
        monkeypatch.setattr(_build, "HOST_LADDER", ladder)
    if source is not None:
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / "medloader.cpp").write_text(source)
        monkeypatch.setattr(_build, "CSRC", csrc)
    tnative._loaded.cache_clear()


@pytest.fixture
def restore_library():
    yield
    tnative._loaded.cache_clear()


def test_ladder_takes_the_next_rung_and_nifti_falls_back_to_gzip(
        monkeypatch, tmp_path, restore_library):
    """A first rung that cannot build (a missing header) gives way to the
    next; built without a gzip backend, ``gzip_read_bytes`` returns None
    and the NIfTI reader inflates with the gzip module."""
    ladder = (("libdeflate", ("-DML_WITH_DEFLATE", "-include",
                              "no_such_header_here.h"), ("-ldeflate",)),
              ("none", (), ()))
    _isolated_build(monkeypatch, tmp_path, ladder)
    assert tnative.backend() == "none"
    assert [p.name.split("-")[1] for p in (tmp_path / "build").iterdir()] \
        == ["none"]
    scan = str(tmp_path / "scan.nii.gz")
    medio.write_image(scan, _ct((6, 7, 8), np.int16, 0))
    assert tnative.gzip_read_bytes(scan) is None
    data, _ = tnifti.read(scan)
    np.testing.assert_array_equal(data, _ct((6, 7, 8), np.int16, 0))


def test_device_modes_raise_the_compilers_error(monkeypatch, tmp_path,
                                                 restore_library,
                                                 tiny_pair):
    """No rung builds: the device modes raise with g++'s own message; no
    path carries on with numpy."""
    _isolated_build(monkeypatch, tmp_path,
                    source="int broken_here(\n")
    _, tds = tiny_pair
    for mode in ("device", "device_cache"):
        with pytest.raises(RuntimeError, match="(?s)every rung.*error"):
            tloader.TrainLoader(tds, batch_size=1, num_workers=1,
                                mode=mode)
    with pytest.raises(RuntimeError, match="every rung"):
        tnative.gzip_read_bytes(__file__)


def test_two_builds_at_once_agree(monkeypatch, tmp_path, restore_library):
    """Two builds racing into one directory (the test workers do) each
    write under a temporary name and move it into place: one library,
    whole, loadable."""
    _isolated_build(monkeypatch, tmp_path, _build.HOST_LADDER[-1:])
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(_build.build_host("medloader")))
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and len(got) == 2
    assert got[0] == got[1]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        got[0][0].name]
    assert tnative.backend() == "none"


# --------------------------------------------------------------------------
# gzip, the fused resize, the NIfTI ingest
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["single", "multi", "corrupt", "plain"])
def test_gzip_read_bytes_matches_jax(tmp_path, kind):
    rng = np.random.RandomState(1)
    payload = (rng.rand(40000) * 50).astype(np.int16).tobytes()
    path = str(tmp_path / "blob.gz")
    blob = {"single": gzip.compress(payload),
            "multi": gzip.compress(payload[:30000]) +
            gzip.compress(payload[30000:]),
            "corrupt": gzip.compress(payload)[:12] + b"\x00" * 500,
            "plain": payload}[kind]
    with open(path, "wb") as f:
        f.write(blob)
    got, want = tnative.gzip_read_bytes(path), jnative.gzip_read_bytes(path)
    if kind in ("corrupt", "plain"):
        assert got is None and want is None
        return
    assert bytes(got) == bytes(want) == payload


def test_gzip_read_bytes_raises_for_a_missing_file(tmp_path):
    with pytest.raises(OSError):
        tnative.gzip_read_bytes(str(tmp_path / "missing.nii.gz"))


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_hu_resize_array_matches_jax(dtype, out_dtype, window):
    vol = _ct((13, 17, 19), dtype, 2)
    kw = dict(out_dtype=out_dtype, window=window)
    got = tnative.hu_resize_array(vol, (7, 9, 23), **kw)
    want = jnative.hu_resize_array(vol, (7, 9, 23), **kw)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (7, 9, 23)
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_hu_resize_array_against_the_plain_hu_resize(dtype):
    """The host kernel against the port's plain version (the torch ops the
    CUDA kernel is held to): ``HU_TOL`` on the window's 0..255 scale."""
    vol = _ct((23, 30, 26), dtype, 3)
    for size in ((8, 12, 10), (40, 31, 27)):  # down and up
        got = tnative.hu_resize_array(vol, size, -1000.0, 400.0, -300.0)
        ref = hr.hu_norm_resize(torch.from_numpy(vol.astype(np.float32)),
                                size, -1000.0, 400.0, -300.0)
        assert (got - ref).abs().max().item() <= HU_TOL


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """A float32 and an int16 scan, each as .nii and .nii.gz."""
    root = tmp_path_factory.mktemp("scans")
    out = {}
    for dtype in (np.float32, np.int16):
        vol = _ct((11, 14, 17), dtype, 4)
        if dtype == np.float32:
            vol = np.nan_to_num(vol)  # the writer keeps NaN; so would both
        for suffix in (".nii", ".nii.gz"):
            path = str(root / "ct_{}{}".format(np.dtype(dtype).name, suffix))
            medio.write_image(path, vol, spacing=(0.7, 0.8, 1.5))
            out[np.dtype(dtype).name, suffix] = path
    return out


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_load_nii_hu_resize_matches_jax(scans, dtype, suffix, out_dtype,
                                        window):
    path = scans[dtype, suffix]
    kw = dict(out_dtype=out_dtype, window=window)
    got = tnative.load_nii_hu_resize(path, (6, 8, 9), **kw)
    want = jnative.load_nii_hu_resize(path, (6, 8, 9), **kw)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # and the same numbers as reading the scan, then the fused resize
    data, _ = tnifti.read(path)
    np.testing.assert_array_equal(
        _bits(got), _bits(tnative.hu_resize_array(data, (6, 8, 9), **kw)))


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_nifti_read_of_a_gz_matches_jax(scans, dtype):
    path = scans[dtype, ".nii.gz"]
    got, meta = tnifti.read(path)
    want, jmeta = jnifti.read(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for key in ("spacing", "origin", "direction"):
        assert meta[key] == jmeta[key]
    np.testing.assert_array_equal(meta["affine"], jmeta["affine"])


def test_load_nii_hu_resize_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "u8.nii")
    medio.write_image(path, np.zeros((4, 5, 6), np.uint8))
    with pytest.raises(RuntimeError, match="code -5"):
        tnative.load_nii_hu_resize(path, (2, 2, 2))
    with pytest.raises(RuntimeError, match="code -1"):
        tnative.load_nii_hu_resize(str(tmp_path / "none.nii"), (2, 2, 2))


# --------------------------------------------------------------------------
# the volume loader
# --------------------------------------------------------------------------
def _npy(path, arr, version):
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, version=version)
    return str(path)


def _volumes(descr, n=3, shape=(5, 6, 7), seed=5):
    rng = np.random.RandomState(seed)
    dt = np.dtype(descr)
    if dt.kind == "f":
        vals = rng.rand(n, *shape) * 600.0 - 300.0
    elif dt.kind == "u":
        vals = rng.randint(0, 256, (n,) + shape)
    else:  # negatives and values past 255 for the u8 clamp
        vals = rng.randint(-400, 400, (n,) + shape)
    return vals.astype(dt)


@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
@pytest.mark.parametrize("descr", DESCRS)
def test_volume_loader_matches_jax(tmp_path, descr, version):
    vols = _volumes(descr)
    paths = [_npy(tmp_path / "v{}.npy".format(i), v, version)
             for i, v in enumerate(vols)]
    ours = tnative.NativeVolumeLoader(paths, threads=2)
    ref = jnative.NativeVolumeLoader(paths, threads=2)
    try:
        assert len(ours) == 3
        for i in range(3):
            assert ours.shape(i) == ref.shape(i) == (5, 6, 7)
            for name in ("load_f32", "load_i32", "load_u8"):
                got, want = getattr(ours, name)(i), getattr(ref, name)(i)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ours.load_f32(1),
                                      vols[1].astype(np.float32))
        for dtype, tdtype in ((np.float32, torch.float32),
                              (np.int32, torch.int32),
                              (np.uint8, torch.uint8)):
            want = ref.load_batch([2, 0, 2], dtype)
            np.testing.assert_array_equal(
                ours.load_batch([2, 0, 2], dtype), want)
            out = torch.full((3, 5, 6, 7), 7, dtype=tdtype)
            assert ours.load_batch([2, 0, 2], tdtype, out=out) is out
            np.testing.assert_array_equal(out.numpy(), want)
    finally:
        ours.close()


def test_fortran_order_raises_as_in_jax(tmp_path):
    path = str(tmp_path / "f.npy")
    np.save(path, np.asfortranarray(np.arange(24, dtype=np.float32)
                                    .reshape(2, 3, 4)))
    with tnative.NativeVolumeLoader([path], threads=1) as ours:
        ref = jnative.NativeVolumeLoader([path], threads=1)
        with pytest.raises(IOError):
            ref.shape(0)
        with pytest.raises(IOError):
            ours.shape(0)
        with pytest.raises(IOError):
            ours.load_f32(0)


def test_volume_loader_checks_what_it_writes_into(tmp_path):
    paths = [_npy(tmp_path / "a.npy", np.zeros((2, 3, 4), np.float32),
                  (1, 0)),
             _npy(tmp_path / "b.npy", np.zeros((2, 3, 5), np.float32),
                  (1, 0))]
    with tnative.NativeVolumeLoader(paths, threads=1) as ours:
        with pytest.raises(ValueError, match="one volume shape"):
            ours.load_batch([0, 1])
        with pytest.raises(ValueError, match="contiguous CPU"):
            ours.load_f32(0, out=torch.zeros(4, 3, 2).transpose(0, 2))
        with pytest.raises(ValueError, match="contiguous CPU"):
            ours.load_f32(0, out=torch.zeros(2, 3, 4, dtype=torch.int32))
        with pytest.raises(ValueError, match="C-contiguous"):
            ours.load_f32(0, out=np.zeros((2, 3, 5), np.float32))
        with pytest.raises(IndexError):
            ours.shape(2)
    with pytest.raises(ValueError, match="closed"):
        ours.shape(0)
    ours.close()  # idempotent


def test_close_waits_for_reads_in_flight(tmp_path):
    """Threads reading while another closes the loader: each read returns
    whole data or raises ValueError ("closed"), never touches freed
    memory; shortened switch interval to interleave them."""
    vols = _volumes("<f4", n=4, shape=(16, 32, 32))
    paths = [_npy(tmp_path / "v{}.npy".format(i), v, (1, 0))
             for i, v in enumerate(vols)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(5):
            ours = tnative.NativeVolumeLoader(paths, threads=2,
                                              cache_bytes=1 << 16)
            bad = []

            def read():
                try:
                    for i in range(40):
                        got = ours.load_batch([i % 4, (i + 1) % 4])
                        if not np.array_equal(got[0], vols[i % 4]):
                            bad.append(i)
                except ValueError:
                    pass

            threads = [threading.Thread(target=read) for _ in range(3)]
            for t in threads:
                t.start()
            ours.close()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads) and not bad
    finally:
        sys.setswitchinterval(interval)


# --------------------------------------------------------------------------
# the loader's device modes against the JAX loader's
# --------------------------------------------------------------------------
def _phase0(root, image_descr, label_descr, shape=(6, 10, 12), n=3,
            classes=3, seed=6):
    phase0 = os.path.join(root, "phase0")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(phase0, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        np.save(os.path.join(phase0, "images", "v{}.npy".format(i)),
                (rng.rand(*shape) * 1200.0 - 200.0).astype(image_descr))
        np.save(os.path.join(phase0, "labels", "v{}.npy".format(i)),
                rng.randint(0, classes, shape).astype(label_descr))
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    for name in ("train_list.txt", "val_list.txt"):
        with open(os.path.join(phase0, name), "w") as f:
            f.writelines(lines)
    return phase0


def _datasets(phase0, repeat=3):
    return (JMedicalDataset(phase0, phase0, [JRandomFlip3D()], 3,
                            repeat_train=repeat),
            MedicalDataset(phase0, phase0, [RandomFlip3D()], 3,
                           repeat_train=repeat))


@pytest.fixture
def tiny_pair(tmp_path):
    return _datasets(_phase0(str(tmp_path), "<f4", "|u1", n=2))


@pytest.mark.parametrize("data", [("<f4", "|u1"), ("<i2", "<i8"),
                                  ("<f8", "<i4")])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["device", "device_cache"])
def test_train_loader_matches_the_jax_loader(tmp_path, mode, wire, data):
    """Two epochs (3 volumes x 3 repeats, batch 2: nine batches) of the
    seeded loader in each device mode equal the JAX loader's, and so does
    the device cache."""
    jds, tds = _datasets(_phase0(str(tmp_path), *data))
    kw = dict(batch_size=2, num_workers=2, seed=4, mode=mode,
              wire_dtype=wire)
    ref = jloader.TrainLoader(jds, **kw)
    ours = tloader.TrainLoader(tds, **kw)
    try:
        assert ref._native_img is not None  # the JAX loader reads natively
        for _ in range(9):
            want, got = next(ref), next(ours)
            if mode == "device_cache":
                np.testing.assert_array_equal(got, want)
                continue
            assert got[0].dtype == {"float32": torch.float32,
                                    "bfloat16": torch.bfloat16}[wire]
            assert got[1].dtype == {"float32": torch.int32,
                                    "bfloat16": torch.uint8}[wire]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_bits(g), _bits(w))
        if mode == "device_cache":
            for g, w in zip(ours.build_device_cache("cpu"),
                            ref.build_device_cache()):
                np.testing.assert_array_equal(_bits(g), _bits(w))
    finally:
        ref.stop()
        ours.stop()
    assert all(reader._handle is None for reader in ours._native)
