"""The port's serving path (medicalseg_torch.deploy.infer) against the JAX
VNet, its config layer, its device rule and its import boundary."""
import os
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


@pytest.mark.parametrize("flag", ["use_swl", "int8", "buckets", "raw"])
def test_unported_paths_raise_not_implemented(tmp_path, flag):
    model_cfg = {"type": "VNet", "num_classes": 2}
    from medicalseg_torch.models import VNet
    from medicalseg_torch.utils import flax_from_state_dict
    variables = flax_from_state_dict(VNet(num_classes=2).state_dict())
    deploy = {"shape_buckets": [[16, 16, 16]]} if flag == "buckets" else {}
    config = _deploy_dir(tmp_path, variables, model_cfg, **deploy)
    extra = {"use_swl": ["--use_swl", "true"],
             "int8": ["--precision", "int8"]}.get(flag, [])
    args = _args(config, str(tmp_path), str(tmp_path / "pred"), "--device",
                 "cpu", *extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        predictor = infer.Predictor(args)
        predictor._preprocess(str(tmp_path / "scan.nii.gz"))


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
        "for name in ('deploy.infer', 'core.state', 'utils.loss_utils', "
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
