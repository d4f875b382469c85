"""The port's deploy runner (medicalseg_torch.deploy.infer) in its raw-scan,
sliding-window, shape-bucket and int8 modes against the JAX package's
runner (deploy/python/infer.py) on the CPU: one small V-Net, the same
weights in both (a flax msgpack there, the transplanted state_dict here),
the same files. float32 unless the mode forces bf16 (int8).
"""
import argparse
import importlib.util
import os
import struct

import numpy as np
import pytest
import yaml

import flax
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu import io as jio
from medicalseg_tpu.models import VNet as JVNet
from medicalseg_torch import io as tio
from medicalseg_torch.core import sliding_window as tsw
from medicalseg_torch.deploy import infer
from medicalseg_torch.utils import quant as tquant
from medicalseg_torch.utils import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_CFG = {"type": "VNet", "in_channels": 1, "num_classes": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_runner():
    """deploy/python/infer.py as a module, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_deploy_infer", os.path.join(ROOT, "deploy", "python",
                                         "infer.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """A directory with one set of weights in both runners' formats and
    the manifests: {name: deploy.yaml path}."""
    tmp = tmp_path_factory.mktemp("deploy")
    rng = np.random.RandomState(0)
    jmodel = JVNet(in_channels=1, num_classes=3)
    variables = jax.jit(lambda k, a: jmodel.init(k, a, train=False))(
        jax.random.PRNGKey(9), jnp.zeros((1, 16, 16, 16, 1)))
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    variables = {"params": jax.device_get(
        flax.core.unfreeze(variables["params"])), "batch_stats": stats}
    (tmp / "model.msgpack").write_bytes(
        flax.serialization.to_bytes(variables))
    torch.save(state_dict_from_flax(variables), tmp / "model.pt")
    paths = {}
    for name, extra in (("plain", {}),
                        ("logits", {"output_op": "none"}),
                        ("buckets", {"shape_buckets": [[16, 16, 16],
                                                       [32, 32, 32]]})):
        for side, params in (("jax", "model.msgpack"), ("port", "model.pt")):
            manifest = {"Deploy": {
                "model": "absent.stablehlo", "params": params,
                "transforms": [], "output_op": "argmax",
                "input_shape_ndhwc": [1, 16, 16, 16, 1],
                "model_config": MODEL_CFG, **extra}}
            path = tmp / "{}_{}.yaml".format(name, side)
            path.write_text(yaml.dump(manifest))
            paths[name, side] = str(path)
    return paths


def _jax_predictor(jax_runner, config, save_dir, **kw):
    args = dict(config=config, image_path="", batch_size=1,
                save_dir=str(save_dir), device="cpu", precision="fp32",
                enable_auto_tune=False, benchmark=False, with_argmax=False,
                use_swl=False)
    args.update(kw)
    return jax_runner.Predictor(argparse.Namespace(**args))


def _port_predictor(config, save_dir, *extra):
    return infer.Predictor(infer.parse_args(
        ["--config", config, "--image_path", "unused", "--save_dir",
         str(save_dir), "--device", "cpu", *extra]))


def _ct(seed, shape):
    vol = np.random.RandomState(seed).uniform(-2000, 1000, shape)
    return vol.astype(np.int16)


def _write_dicom_slice(path, pixels, instance, z):
    """Minimal explicit-VR little-endian DICOM slice."""
    def elem(group, el, vr, value):
        head = struct.pack("<HH", group, el) + vr
        if vr == b"OW":
            return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    rows, cols = pixels.shape
    body = b"".join([
        elem(0x0018, 0x0050, b"DS", b"2.5 "),
        elem(0x0020, 0x0013, b"IS", str(instance).encode()),
        elem(0x0020, 0x0032, b"DS", "0.0\\0.0\\{}".format(z).encode()),
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


def test_raw_scan_through_both_runners(deployed, jax_runner, tmp_path):
    """A 20 x 24 x 28 int16 .nii.gz: read, HU window, resize to 16^3, /max,
    V-Net, argmax, in both runners."""
    scan = str(tmp_path / "scan.nii.gz")
    jio.write_image(scan, _ct(1, (20, 24, 28)), spacing=(0.7, 0.7, 2.5))
    jpred = _jax_predictor(jax_runner, deployed["plain", "jax"],
                           tmp_path / "jax")
    pred = _port_predictor(deployed["plain", "port"], tmp_path / "port",
                           "--precision", "fp32", "--benchmark", "true")
    ref_x = jpred._preprocess(scan)
    x = pred._preprocess(scan)
    assert x.dtype == torch.float32 and tuple(x.shape) == ref_x.shape == (
        1, 16, 16, 16, 1)
    # 1e-3 on the window's 0..255 scale, after the division by the max
    np.testing.assert_allclose(x.numpy(), ref_x, atol=1e-3 / 255)
    ref = np.load(jpred.run([scan])[0])
    out = pred.run([scan])
    assert [os.path.basename(p) for p in out] == ["scan.nii.npy"]
    got = np.load(out[0])
    assert got.dtype == ref.dtype == np.int32 and got.shape == (16, 16, 16)
    assert (got == ref).mean() >= 0.999
    assert len(pred.timer.stages["preprocess"]) == 1


@pytest.mark.parametrize("form", [".nii", ".mha", ".mhd", ".nrrd", ".npy",
                                  "dicom_dir", ".dcm"])
def test_preprocess_reads_every_supported_form(deployed, tmp_path, form):
    """Whatever the container, the same voxels give the same preprocessed
    volume as the .nii.gz the JAX runner was held to."""
    pred = _port_predictor(deployed["plain", "port"], tmp_path / "port")
    vol = _ct(2, (6, 10, 12))
    ref_path = str(tmp_path / "ref.nii.gz")
    tio.write_image(ref_path, vol)
    if form == "dicom_dir":
        path = str(tmp_path / "series")
        os.makedirs(path)
        for i in range(vol.shape[0]):
            _write_dicom_slice(os.path.join(path, "s{}.dcm".format(i)),
                               vol[i], i + 1, 2.5 * i)
    elif form == ".dcm":
        path = str(tmp_path / "slice.dcm")
        _write_dicom_slice(path, vol[0], 1, 0.0)
        tio.write_image(ref_path, vol[:1])
    else:
        path = str(tmp_path / ("vol" + form))
        tio.write_image(path, vol)
    got = pred._preprocess(path)
    if form == ".npy":  # taken as it is: no window, no resize
        assert tuple(got.shape) == (1, 6, 10, 12, 1)
        np.testing.assert_allclose(got[0, ..., 0].numpy(),
                                   vol / np.float32(vol.max()), rtol=1e-6)
    else:
        assert torch.equal(got, pred._preprocess(ref_path))


def test_sliding_window_mode_through_both_runners(deployed, jax_runner,
                                                  tmp_path):
    """--use_swl: scans keep their native resolution (HU window only); two
    20 x 16 x 24 scans share one window stream (batch_size 2), a third of
    another shape flushes on its own."""
    scans = []
    for i, shape in enumerate([(20, 16, 24), (20, 16, 24), (12, 16, 20)]):
        scans.append(str(tmp_path / "scan{}.nii.gz".format(i)))
        jio.write_image(scans[-1], _ct(10 + i, shape))
    jpred = _jax_predictor(jax_runner, deployed["plain", "jax"],
                           tmp_path / "jax", use_swl=True, batch_size=2)
    pred = _port_predictor(deployed["plain", "port"], tmp_path / "port",
                           "--use_swl", "true", "--batch_size", "2",
                           "--precision", "fp32")
    assert pred.window_batch == 4  # the JAX scan's default
    x = pred._preprocess(scans[0])
    assert tuple(x.shape) == (1, 20, 16, 24, 1)
    np.testing.assert_allclose(x.numpy(), jpred._preprocess(scans[0]),
                               atol=1e-6)
    refs = [np.load(p) for p in jpred.run(scans[:2])]
    outs = pred.run(scans)
    assert len(outs) == 3 and len(pred.timer.stages["inference"]) == 2
    for got, ref in zip([np.load(p) for p in outs], refs):
        assert got.shape == ref.shape == (20, 16, 24)
        assert got.dtype == ref.dtype == np.int32
        assert (got == ref).mean() >= 0.999
    third = tsw.sliding_window_inference(
        pred.model.main_output, pred._preprocess(scans[2])[0], (16, 16, 16),
        3)
    np.testing.assert_array_equal(np.load(outs[2]),
                                  third.argmax(-1).numpy())

    logits = _port_predictor(deployed["logits", "port"], tmp_path / "raw",
                             "--use_swl", "true", "--with_argmax")
    out = np.load(logits.run(scans[2])[0])  # output_op none: the logits
    np.testing.assert_allclose(out, third.numpy(), atol=1e-6)


def test_shape_buckets_pad_crop_and_resize(deployed, jax_runner, tmp_path):
    """16^3 takes the 16-bucket, 24^3 is zero-padded into the 32-bucket and
    cropped back, 20 x 40 x 20 fits none and is resized to the largest;
    consecutive same-bucket volumes share a batch."""
    rng = np.random.RandomState(1)
    paths = []
    for i, shape in enumerate([(16,) * 3, (24,) * 3, (20, 24, 28),
                               (20, 40, 20)]):
        paths.append(str(tmp_path / "v{}.npy".format(i)))
        np.save(paths[-1], rng.rand(*shape).astype(np.float32))
    pred = _port_predictor(deployed["buckets", "port"], tmp_path / "port",
                           "--batch_size", "2", "--precision", "fp32")
    assert pred._bucket_for((16, 16, 16)) == (16, 16, 16)
    assert pred._bucket_for((16, 17, 16)) == (32, 32, 32)
    assert pred._bucket_for((33, 8, 8)) is None
    outs = [np.load(p) for p in pred.run(paths)]
    assert [o.shape for o in outs] == [(16,) * 3, (24,) * 3, (20, 24, 28),
                                       (32,) * 3]
    assert all(o.dtype == np.int32 for o in outs)
    # v0 alone, v1 + v2 as one batch of the 32-bucket, v3 alone (batch
    # full)
    assert len(pred.timer.stages["inference"]) == 3

    jpred = _jax_predictor(jax_runner, deployed["buckets", "jax"],
                           tmp_path / "jax")
    for i in (0, 1):
        ref = np.load(jpred.run([paths[i]])[0])
        assert ref.shape == outs[i].shape
        assert (outs[i] == ref).mean() >= 0.999
    with torch.inference_mode():
        x = pred._preprocess(paths[2])
        padded = torch.nn.functional.pad(x, (0, 0, 0, 4, 0, 8, 0, 12))
        direct = pred.model(padded)[0][0, :20, :24, :28].argmax(-1)
    np.testing.assert_array_equal(outs[2], direct.numpy())


def test_int8_serving_holds_int8_weights_and_agrees(deployed, jax_runner,
                                                    tmp_path):
    """--precision int8: both runners quantize at load time to the same
    int8 weights and scales, bit for bit, compute in bf16, and agree with
    each other and with the port's fp32 serving on most voxels of a
    random-init net (0.9, the JAX package's own bar for int8)."""
    path = str(tmp_path / "v.npy")
    np.save(path, np.random.RandomState(2).rand(16, 16, 16).astype(
        np.float32))
    jpred = _jax_predictor(jax_runner, deployed["plain", "jax"],
                           tmp_path / "jax", precision="int8")
    pred = _port_predictor(deployed["plain", "port"], tmp_path / "port",
                           "--precision", "int8")
    assert pred.model.dtype == torch.bfloat16
    assert all(p.is_meta for p in pred.model.parameters())
    moved = state_dict_from_flax(jax.device_get(jpred._variables))
    assert sorted(moved) == sorted(pred._qstate)
    n_int8 = 0
    for name, t in pred._qstate.items():
        assert t.dtype == moved[name].dtype and torch.equal(t, moved[name])
        n_int8 += t.dtype == torch.int8
    assert n_int8 == 24
    for name in ("in_tr.conv1.weight", "down_tr64.down_conv.weight",
                 "up_tr128.up_conv.weight", "out_tr.conv1.weight"):
        assert pred._qstate[name + tquant.QUANT_SUFFIX].dtype == torch.int8
    got = np.load(pred.run([path])[0])
    ref = np.load(jpred.run([path])[0])
    fp32 = np.load(_port_predictor(
        deployed["plain", "port"], tmp_path / "fp32", "--precision",
        "fp32").run([path])[0])
    assert got.shape == (16, 16, 16) and got.dtype == np.int32
    assert (got == ref).mean() >= 0.9
    assert (got == fp32).mean() >= 0.9

    swl = _port_predictor(deployed["plain", "port"], tmp_path / "swl",
                          "--precision", "int8", "--use_swl", "true")
    assert np.load(swl.run([path])[0]).shape == (16, 16, 16)


def test_softmax_and_with_argmax_on_a_raw_scan(deployed, tmp_path):
    scan = str(tmp_path / "scan.mha")
    tio.write_image(scan, _ct(3, (8, 20, 18)))
    pred = _port_predictor(deployed["logits", "port"], tmp_path / "a")
    logits = np.load(pred.run(scan)[0])
    assert logits.shape == (16, 16, 16, 3) and logits.dtype == np.float32
    pred = _port_predictor(deployed["logits", "port"], tmp_path / "b",
                           "--with_argmax")
    np.testing.assert_array_equal(np.load(pred.run([scan])[0]),
                                  logits.argmax(-1))
