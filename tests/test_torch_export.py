"""The port's export (``python -m medicalseg_torch.export``) and its runner
reading the whole manifest, against the JAX package's ``export.py`` and
``deploy/python/infer.py`` on the CPU.

A V-Net of 2 classes, float32, its weights one seeded JAX init with
non-trivial BatchNorm statistics in a ``model.msgpack``, exported by both
CLIs at [2, 1, 16, 16, 16] with the buckets 16^3 and 32^3 (the shapes of
tests/test_export_deploy.py). Each export directory is served by both
runners. Tolerances: a runner's predictions against the port's module
rebuilt from the manifest, fed the same preprocessed volumes, on >= 99.9%
of voxels (the share tests/test_torch_deploy_modes.py holds the two
runners to: two f32 forwards of 16 convs summed in other orders); the
port's runner through its own ``.pt2`` programs exactly (the program runs
the module's ops).
"""
import argparse
import importlib.util
import logging
import os
import shutil

import numpy as np
import pytest
import yaml

import flax
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.models import VNet as JVNet
from medicalseg_torch import export as texport
from medicalseg_torch.deploy import infer
from medicalseg_torch.ops import conv5 as c5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST_KEYS = {"model", "params", "transforms", "input_shape_ndhwc",
                 "shape_buckets", "bucket_models", "output_op",
                 "model_config"}
AGREE = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_root_module(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_runner():
    return _load_root_module("jax_deploy_infer_export", "deploy", "python",
                             "infer.py")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{'jax' | 'port': export directory}, and the weights file: both CLIs
    on one config and one ``model.msgpack``."""
    tmp = tmp_path_factory.mktemp("export")
    cfg = tmp / "cfg.yml"
    cfg.write_text(yaml.dump({
        "data_root": "data/", "iters": 10,
        "model": {"type": "VNet", "in_channels": 1, "num_classes": 2},
        "val_dataset": {"type": "MedicalDataset", "transforms": []}}))
    jmodel = JVNet(in_channels=1, num_classes=2)
    variables = jax.jit(lambda k, a: jmodel.init(k, a, train=False))(
        jax.random.PRNGKey(11), jnp.zeros((1, 16, 16, 16, 1)))
    rng = np.random.RandomState(11)
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    variables = {"params": jax.device_get(
        flax.core.unfreeze(variables["params"])), "batch_stats": stats}
    weights = tmp / "weights.msgpack"
    weights.write_bytes(flax.serialization.to_bytes(variables))

    jax_export = _load_root_module("jax_export_cli", "export.py")
    dirs = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    jax_export.main(argparse.Namespace(
        cfg=str(cfg), save_dir=dirs["jax"], model_path=str(weights),
        without_argmax=False, with_softmax=False,
        input_shape=[2, 1, 16, 16, 16], shape_buckets=[16, 16, 16, 32, 32,
                                                       32]))
    texport.main(texport.parse_args([
        "--config", str(cfg), "--save_dir", dirs["port"], "--model_path",
        str(weights), "--input_shape", "2", "1", "16", "16", "16",
        "--shape_buckets", "16", "16", "16", "32", "32", "32", "--device",
        "cpu"]))
    for path in dirs.values():  # a manifest of the same dir without buckets
        with open(os.path.join(path, "deploy.yaml")) as f:
            manifest = yaml.safe_load(f)
        manifest["Deploy"].update(shape_buckets=[], bucket_models={})
        with open(os.path.join(path, "deploy_plain.yaml"), "w") as f:
            yaml.dump(manifest, f)
    yield dirs, str(weights)
    shutil.rmtree(tmp, ignore_errors=True)  # ~1 GB of weights and programs


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Four 16^3 volumes (plain batches) and three 20^3 plus one 16^3
    (the 32^3 and the 16^3 bucket), seeded."""
    tmp = tmp_path_factory.mktemp("volumes")
    rng = np.random.RandomState(3)
    out = {"plain": [], "buckets": []}
    for name, shapes in (("plain", [(16,) * 3] * 4),
                         ("buckets", [(20,) * 3] * 3 + [(16,) * 3])):
        for i, shape in enumerate(shapes):
            path = str(tmp / "{}{}.npy".format(name, i))
            np.save(path, (rng.rand(*shape) * 100).astype(np.float32))
            out[name].append(path)
    return out


def _port_predictor(config, save_dir, *extra):
    return infer.Predictor(infer.parse_args(
        ["--config", config, "--image_path", "unused", "--save_dir",
         str(save_dir), "--device", "cpu", *extra]))


def _jax_predictor(jax_runner, config, save_dir, batch_size):
    return jax_runner.Predictor(argparse.Namespace(
        config=config, image_path="", batch_size=batch_size,
        save_dir=str(save_dir), device="cpu", precision="fp32",
        enable_auto_tune=False, benchmark=False, with_argmax=False,
        use_swl=False))


def _reference(dirs, paths, tmp_path):
    """The argmax of the port's rebuilt module on each volume, padded into
    the bucket a runner routes it to and cropped back."""
    pred = _port_predictor(os.path.join(dirs["jax"], "deploy.yaml"),
                           tmp_path / "ref", "--batch_size", "1")
    out = []
    with torch.inference_mode():
        for path in paths:
            x = pred._preprocess(path)
            d, h, w = x.shape[1:4]
            bucket = pred._bucket_for((d, h, w))
            x = torch.nn.functional.pad(
                x, (0, 0, 0, bucket[2] - w, 0, bucket[1] - h, 0,
                    bucket[0] - d))
            out.append(pred.model(x)[0][0, :d, :h, :w].argmax(-1).numpy())
    return out


def _pt2_calls(graph):
    """(custom op names, kernel edges of the aten convolutions) of an
    exported graph."""
    ops, edges = [], []
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target)
        if name.startswith("medicalseg."):
            ops.append(name)
        elif "conv" in name:
            edges.append(tuple(node.args[1].meta["val"].shape[2:]))
    return ops, edges


@pytest.mark.parametrize("args", [
    ("head", (2, 4, 3, 5, 6), torch.float32),
    ("head", (1, 3, 8, 4, 5), torch.bfloat16),
    ("stem", (2, 5, 1, 6, 7), torch.float32)])
def test_conv5_fused_op_passes_opcheck(args):
    """The schema, the fake implementation (shape, dtype, contiguous
    strides) against the CPU one, and a trace through AOT dispatch with
    dynamic shapes."""
    kind, shape, dtype = args
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(dtype)
    co = 16 if kind == "stem" else 3
    w = torch.randn(5, 5, 5, shape[2], co, generator=g)
    ep = [torch.rand(co, generator=g) for _ in range(4)]
    got = c5.conv5_kl_fused(x, w, ep[0], ep[1:], kind)
    assert got.is_contiguous() and got.dtype == dtype
    torch.testing.assert_close(got, c5.conv5_kl_plain(x, w, ep[0], ep[1:]),
                               rtol=0, atol=0)
    result = torch.library.opcheck(torch.ops.medicalseg.conv5_fused.default,
                                   (x, w, *ep, kind))
    assert set(result.values()) == {"SUCCESS"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pin_op_passes_opcheck(dtype):
    x = torch.randn(2, 3, 4, 5, 6).to(dtype).permute(0, 2, 1, 3, 4)
    got = c5.pin_kl(x)
    assert got.is_contiguous() and torch.equal(got, x)
    assert got.data_ptr() != x.data_ptr()
    result = torch.library.opcheck(torch.ops.medicalseg.pin.default, (x,))
    assert set(result.values()) == {"SUCCESS"}
    contiguous = x.contiguous()
    assert c5.pin_kl(contiguous) is contiguous  # the early return stays


def test_export_writes_programs_weights_and_the_jax_manifest(exported):
    dirs, _ = exported
    manifests = {}
    for side, path in dirs.items():
        with open(os.path.join(path, "deploy.yaml")) as f:
            manifests[side] = yaml.safe_load(f)["Deploy"]
        assert set(manifests[side]) == MANIFEST_KEYS
    port, jax_ = manifests["port"], manifests["jax"]
    assert port["model"] == "model.pt2" and port["params"] == "model.msgpack"
    assert port["bucket_models"] == {"16x16x16": "model_16x16x16.pt2",
                                     "32x32x32": "model_32x32x32.pt2"}
    for key in MANIFEST_KEYS - {"model", "bucket_models"}:
        assert port[key] == jax_[key], key
    for name in ("model.pt2", "model_16x16x16.pt2", "model_32x32x32.pt2",
                 "model.msgpack"):
        assert os.path.getsize(os.path.join(dirs["port"], name)) > 0
    # the weights file: the same tensors as the JAX export's
    port_sd = infer.read_params(os.path.join(dirs["port"], "model.msgpack"))
    jax_sd = infer.read_params(os.path.join(dirs["jax"], "model.msgpack"))
    assert sorted(port_sd) == sorted(jax_sd)
    for key in port_sd:
        assert torch.equal(port_sd[key], jax_sd[key]), key


def test_exported_graph_holds_the_kernel_ops(exported):
    """Every 5^3 conv is a ``medicalseg::conv5_fused`` node (16 a
    forward) and every pin a ``medicalseg::pin`` node (7 at 16^3: the
    eighth view, the 1^3 level, is contiguous); the only aten convolutions
    are the 2^3 down and up convs."""
    dirs, _ = exported
    for name, pins in (("model.pt2", 7), ("model_32x32x32.pt2", 8)):
        program = torch.export.load(os.path.join(dirs["port"], name))
        ops, edges = _pt2_calls(program.graph)
        assert ops.count("medicalseg.conv5_fused.default") == 16
        assert ops.count("medicalseg.pin.default") == pins
        assert len(edges) == 8 and set(edges) == {(2, 2, 2)}
        inputs = [n for n in program.graph.nodes if n.op == "placeholder"
                  and n.name in program.graph_signature.user_inputs]
        assert len(inputs) == 1 and inputs[0].meta["val"].shape[0] == 2


@pytest.mark.parametrize("runner", ["jax", "port"])
@pytest.mark.parametrize("side", ["jax", "port"])
def test_both_export_dirs_through_both_runners(exported, volumes, jax_runner,
                                               tmp_path, runner, side):
    """Plain batches and buckets. The port's runner takes batches of 3 and
    the programs' N is 2, so each request is split into a block of 2 and
    a block of 1 padded to 2 (the JAX runner's plain path has no split:
    it gets batches of 2)."""
    dirs, _ = exported
    refs = _reference(dirs, volumes["plain"] + volumes["buckets"], tmp_path)
    outs = []
    for manifest, paths in (("deploy_plain.yaml", volumes["plain"]),
                            ("deploy.yaml", volumes["buckets"])):
        config = os.path.join(dirs[side], manifest)
        save = tmp_path / manifest
        if runner == "port":
            pred = _port_predictor(config, save, "--batch_size", "3")
            outs += [np.load(p) for p in pred.run(paths)]
            through = (pred._program if manifest == "deploy_plain.yaml"
                       else pred._bucket_calls[(32, 32, 32)])
            # the port's programs serve; the JAX StableHLO does not load
            assert (through is not None) == (side == "port")
        else:
            batch = 2 if manifest == "deploy_plain.yaml" else 3
            pred = _jax_predictor(jax_runner, config, save, batch)
            outs += [np.load(p) for p in pred.run(paths)]
            assert (pred._exported is not None) == (side == "jax")
    assert [o.shape for o in outs] == [r.shape for r in refs]
    for got, ref in zip(outs, refs):
        assert got.dtype == np.int32
        if runner == side == "port":
            np.testing.assert_array_equal(got, ref)
        else:
            assert (got == ref).mean() >= AGREE


def test_program_serves_the_params_files_weights(exported, volumes,
                                                 tmp_path):
    """The weights served are the params file's, not those stored in the
    program: a copy of the directory whose ``model.msgpack`` holds other
    BatchNorm shifts serves what the rebuilt module serves with them."""
    dirs, _ = exported
    copy = tmp_path / "copy"
    copy.mkdir()
    with open(os.path.join(dirs["port"], "deploy_plain.yaml")) as f:
        manifest = yaml.safe_load(f)
    manifest["Deploy"]["model"] = os.path.join(dirs["port"], "model.pt2")
    (copy / "deploy_plain.yaml").write_text(yaml.dump(manifest))
    state = infer.read_params(os.path.join(dirs["port"], "model.msgpack"))
    state["out_tr.bn1.bias"] = state["out_tr.bn1.bias"] + torch.tensor(
        [2.0, -2.0])
    from medicalseg_torch.utils import flax_from_state_dict
    from medicalseg_torch.utils.msgpack_codec import packb
    (copy / "model.msgpack").write_bytes(packb(flax_from_state_dict(state)))
    pred = _port_predictor(str(copy / "deploy_plain.yaml"), tmp_path / "out",
                           "--batch_size", "2")
    assert pred._program is not None
    paths = volumes["plain"][:2]
    got = [np.load(p) for p in pred.run(paths)]
    with torch.inference_mode():
        x = torch.cat([pred._preprocess(p) for p in paths])
        ref = pred.model(x)[0].argmax(-1).numpy()
        base = _port_predictor(os.path.join(dirs["port"], "deploy_plain.yaml"),
                               tmp_path / "base")
        before = base.model(x)[0].argmax(-1).numpy()
    np.testing.assert_array_equal(np.stack(got), ref)
    assert (ref != before).any()
    shutil.rmtree(copy)  # 180 MB of weights


def test_packed_weights_through_the_program(exported, monkeypatch):
    """The conv kernels' packed-weight cache (``_packed_weight``) keys on
    the parameter a permuted view comes from; in an exported program the
    permute is a graph node. Packing from inside the op on each call: a
    second forward finds every packing in the cache, and a
    ``load_state_dict`` packs every weight again."""
    dirs, _ = exported
    packed = []
    plain = c5.conv5_kl_plain

    def recording(xk, w, b, ep=None):
        packed.append(c5._packed_weight(
            w, "stem" if xk.shape[2] == 1 else 16))
        return plain(xk, w, b, ep)

    monkeypatch.setattr(c5, "conv5_kl_plain", recording)
    module = torch.export.load(os.path.join(dirs["port"],
                                            "model.pt2")).module()
    x = torch.rand(2, 16, 16, 16, 1)
    with torch.inference_mode():
        module(x)
        first = list(packed)
        packed.clear()
        module(x)
    assert len(first) == 16
    assert all(a is b for a, b in zip(first, packed))
    module.load_state_dict(module.state_dict())
    packed.clear()
    with torch.inference_mode():
        module(x)
    assert all(a is not b for a, b in zip(first, packed))


def test_runner_logs_and_refuses(exported, tmp_path):
    """The runner logs which path serves; a ``--precision`` other than the
    program's dtype takes the rebuilt module; a ``.pt2`` that does not
    load raises; the export CLI raises without a GPU unless asked for the
    CPU."""
    dirs, _ = exported
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("medicalseg_torch").addHandler(handler)
    try:
        config = os.path.join(dirs["port"], "deploy_plain.yaml")
        assert _port_predictor(config, tmp_path / "f")._program is not None
        pred = _port_predictor(config, tmp_path / "bf16", "--precision",
                               "bf16")
        _port_predictor(os.path.join(dirs["jax"], "deploy_plain.yaml"),
                        tmp_path / "j")
    finally:
        logging.getLogger("medicalseg_torch").removeHandler(handler)
    assert pred._program is None
    assert [r for r in records if r.startswith("model: ")] == [
        "model: serving through the exported program {} at [2, 16, 16, 16, "
        "1]".format(os.path.join(dirs["port"], "model.pt2")),
        "model: serving through the module rebuilt from model_config "
        "(--precision bf16 and a torch.float32 program)",
        "model: serving through the module rebuilt from model_config ({} is "
        "not a .pt2 program)".format(os.path.join(dirs["jax"],
                                                  "model.stablehlo"))]
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "model.pt2").write_bytes(b"not a program")
    with open(os.path.join(dirs["port"], "deploy_plain.yaml")) as f:
        manifest = yaml.safe_load(f)
    manifest["Deploy"]["params"] = os.path.join(dirs["port"],
                                                "model.msgpack")
    (broken / "deploy.yaml").write_text(yaml.dump(manifest))
    with pytest.raises(Exception):
        _port_predictor(str(broken / "deploy.yaml"), tmp_path / "x")
    (broken / "model.pt2").unlink()  # missing: the rebuilt module serves
    assert _port_predictor(str(broken / "deploy.yaml"),
                           tmp_path / "y")._program is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            texport.main(texport.parse_args([
                "--config", "unused.yml", "--save_dir", str(tmp_path)]))
