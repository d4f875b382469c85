"""The port's serving path (medicalseg_torch.deploy.infer) against the JAX
VNet, its config layer, its device rule and its import boundary."""
import argparse
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

import flax
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.models import VNet as JVNet
from medicalseg_torch.cvlibs import Config
from medicalseg_torch.deploy import infer
from medicalseg_torch.utils import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUNG_TPU = os.path.join(
    ROOT, "configs", "lung_coronavirus",
    "vnet_lung_coronavirus_128_128_128_15k_tpu.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _deploy_dir(tmp_path, variables, model_cfg, **deploy):
    torch.save(state_dict_from_flax(variables), tmp_path / "model.pt")
    manifest = {"Deploy": {"model": "model.stablehlo", "params": "model.pt",
                           "transforms": [], "output_op": "argmax",
                           "model_config": model_cfg, **deploy}}
    path = tmp_path / "deploy.yaml"
    path.write_text(yaml.dump(manifest))
    return str(path)


def _args(config, image_path, save_dir, *extra):
    return infer.parse_args(["--config", config, "--image_path", image_path,
                             "--save_dir", save_dir, *extra])


def test_predictor_argmax_matches_jax_vnet(tmp_path):
    """Two seeded 16^3 volumes through the port's Predictor (CPU, fp32,
    batch 2) from a deploy.yaml carrying the _tpu lung config's model
    section; the saved argmax equals the JAX VNet's on the same
    preprocessed input."""
    model_cfg = Config(LUNG_TPU).dic["model"]
    jcfg = {k: v for k, v in model_cfg.items() if k != "type"}
    jcfg["dtype"] = jnp.float32
    jmodel = JVNet(**jcfg)
    rng = np.random.RandomState(0)
    imgs = tmp_path / "images"
    imgs.mkdir()
    vols = [(rng.rand(16, 16, 16) * 1000).astype(np.float32)
            for _ in range(2)]
    for i, v in enumerate(vols):
        np.save(imgs / "vol{}.npy".format(i), v)
    variables = jax.jit(lambda k, a: jmodel.init(k, a, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 16, 1)))
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    variables = {"params": jax.device_get(
        flax.core.unfreeze(variables["params"])), "batch_stats": stats}
    config = _deploy_dir(tmp_path, variables, model_cfg)
    out_dir = str(tmp_path / "pred")
    args = _args(config, str(imgs), out_dir, "--device", "cpu",
                 "--precision", "fp32", "--batch_size", "2",
                 "--benchmark", "true")
    predictor = infer.Predictor(args)
    assert predictor.model.dtype == torch.float32
    paths = sorted(predictor.run(sorted(str(p) for p in imgs.iterdir())))
    assert predictor.timer.stages["inference"]

    x = np.concatenate([predictor._preprocess(str(imgs / "vol{}.npy".format(
        i))) for i in range(2)])
    np.testing.assert_allclose(
        x[..., 0], np.stack([v / v.max() for v in vols]), rtol=1e-7)
    ref = np.asarray(jnp.argmax(jax.jit(
        lambda v, a: jmodel.apply(v, a, train=False))(variables, x)[0], -1))
    for i, path in enumerate(paths):
        got = np.load(path)
        assert got.dtype == np.int32 and got.shape == (16, 16, 16)
        np.testing.assert_array_equal(got, ref[i])


def test_config_builds_port_vnet_from_tpu_yaml():
    cfg = Config(LUNG_TPU)
    assert cfg.dic["batch_size"] == 6  # from the _base_ chain
    assert cfg.dic["data_root"] == "data/"
    model = cfg.model
    assert type(model).__module__ == "medicalseg_torch.models.vnet"
    assert model.dtype == torch.bfloat16  # 'bfloat16' -> torch dtype
    assert model.out_tr.conv2.weight.shape[0] == 3


def test_cli_main_runs_on_cpu(tmp_path):
    from medicalseg_torch.models import VNet
    from medicalseg_torch.utils import flax_from_state_dict
    model_cfg = {"type": "VNet", "num_classes": 2, "dtype": "float32"}
    variables = flax_from_state_dict(VNet(num_classes=2).state_dict())
    config = _deploy_dir(tmp_path, variables, model_cfg,
                         output_op="softmax")
    np.save(tmp_path / "a.npy", np.ones((16, 16, 16), np.float32))
    out_dir = tmp_path / "pred"
    infer.main(_args(config, str(tmp_path / "a.npy"), str(out_dir),
                     "--device", "cpu"))
    probs = np.load(out_dir / "a.npy")
    assert probs.shape == (16, 16, 16, 2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_runner():
    """deploy/python/infer.py as a module, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_deploy_infer_serving", os.path.join(ROOT, "deploy", "python",
                                                 "infer.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def msgpack_weights(tmp_path_factory):
    """A seeded JAX VNet (2 classes) with non-trivial BatchNorm statistics
    as one ``model.msgpack``, the params file of both runners."""
    tmp = tmp_path_factory.mktemp("weights")
    path = tmp / "model.msgpack"
    jmodel = JVNet(in_channels=1, num_classes=2)
    variables = jax.jit(lambda k, a: jmodel.init(k, a, train=False))(
        jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 16, 1)))
    rng = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    variables = {"params": jax.device_get(
        flax.core.unfreeze(variables["params"])), "batch_stats": stats}
    path.write_bytes(flax.serialization.to_bytes(variables))
    yield path
    shutil.rmtree(tmp, ignore_errors=True)  # 180 MB of weights


# (transforms of the manifest, volume written, deploy extras, port flags)
# per serving mode: each transform changes the volume the model sees
TRANSFORM_MODES = {
    "use_swl": ([{"type": "Resize3D", "size": [20, 24, 28]}], "npy", {},
                ["--use_swl", "true"]),
    "int8": ([{"type": "Resize3D", "size": 32, "order": 1}], "npy", {},
             ["--precision", "int8"]),
    "buckets": ([{"type": "Resize3D", "size": 24}], "npy",
                {"shape_buckets": [[16, 16, 16], [32, 32, 32]]}, []),
    "raw": ([{"type": "Resize3D", "size": [32, 32, 32]}], "nii.gz", {}, []),
}


@pytest.mark.parametrize("flag", ["use_swl", "int8", "buckets", "raw"])
def test_unported_paths_raise_not_implemented(tmp_path, flag, jax_runner,
                                              msgpack_weights):
    """A non-empty ``transforms`` list in the manifest, once refused with
    ``NotImplementedError``, is served in every mode: the port's runner
    and ``deploy/python/infer.py`` read one manifest and one
    ``model.msgpack``, run the host transforms after the HU window and
    resize and before the division by the max, and agree. The
    preprocessed volumes within 1e-6 (1e-3 / 255 for the raw scan, whose
    window and resize run in f32 in other orders); the saved predictions
    on >= 99.9% of voxels in f32 and >= 90% with int8 weights (bf16
    compute, the JAX package's own bar for int8)."""
    transforms, form, deploy, extra = TRANSFORM_MODES[flag]
    manifest = {"Deploy": {  # params by its absolute path: no copy
        "model": "model.stablehlo", "params": str(msgpack_weights),
        "transforms": transforms, "output_op": "argmax",
        "input_shape_ndhwc": [1, 16, 16, 16, 1],
        "model_config": {"type": "VNet", "num_classes": 2}, **deploy}}
    config = tmp_path / "deploy.yaml"
    config.write_text(yaml.dump(manifest))
    rng = np.random.RandomState(7)
    if form == "npy":
        path = str(tmp_path / "vol.npy")
        np.save(path, rng.rand(16, 16, 16).astype(np.float32))
    else:
        from medicalseg_torch import io as medio
        path = str(tmp_path / "scan.nii.gz")
        medio.write_image(path, rng.randint(-1500, 800, (10, 12, 14)).astype(
            np.int16))

    predictor = infer.Predictor(_args(
        str(config), path, str(tmp_path / "port"), "--device", "cpu",
        *extra))
    assert [type(t).__name__ for t in predictor.transforms] == ["Resize3D"]
    jargs = argparse.Namespace(
        config=str(config), image_path=path, batch_size=1,
        save_dir=str(tmp_path / "jax"), device="cpu",
        precision="int8" if flag == "int8" else "fp32",
        enable_auto_tune=False, benchmark=False, with_argmax=False,
        use_swl=flag == "use_swl")
    jpredictor = jax_runner.Predictor(jargs)

    x = predictor._preprocess(path).numpy()
    ref_x = jpredictor._preprocess(path)
    size = transforms[0]["size"]
    assert x.shape == ref_x.shape == (1, *(
        size if isinstance(size, list) else [size] * 3), 1)
    np.testing.assert_allclose(x, ref_x, atol=1e-3 / 255 if form != "npy"
                               else 1e-6)
    got = np.load(predictor.run([path])[0])
    ref = np.load(jpredictor.run([path])[0])
    assert got.shape == ref.shape == x.shape[1:4]
    assert got.dtype == ref.dtype == np.int32
    assert (got == ref).mean() >= (0.9 if flag == "int8" else 0.999)


def test_cuda_entry_point_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.resolve_device("cuda")
    assert infer.resolve_device("cpu") == torch.device("cpu")
    args = _args(str(tmp_path / "deploy.yaml"), str(tmp_path),
                 str(tmp_path / "pred"))
    assert args.device == "cuda"  # the default
    (tmp_path / "deploy.yaml").write_text(yaml.dump({"Deploy": {}}))
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.Predictor(args)


def test_port_imports_neither_jax_nor_medicalseg_tpu():
    code = (
        "import sys, pkgutil, importlib, medicalseg_torch\n"
        "for m in pkgutil.walk_packages(medicalseg_torch.__path__, "
        "'medicalseg_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'medicalseg_tpu'))\n"
        "for name in ('deploy.infer', 'core.state', 'core.infer', "
        "'core.sliding_window', 'io.nifti', 'io.dicom', 'ops.hu_resize', "
        "'ops.resize', 'ops.intensity', 'utils.quant', 'utils.loss_utils', "
        "'utils.transplant', 'cvlibs.config', 'models.losses.loss_utils', "
        "'models.losses.cross_entropy_loss', 'models.losses.dice_loss', "
        "'models.losses.mixed_loss', "
        "'models.losses.binary_cross_entropy_loss'):\n"
        "    assert 'medicalseg_torch.' + name in sys.modules, name\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
