"""The port's entry points set its f32 policy (``utils.strict_f32``): after
the setup of ``train.main``, ``val.main``, ``export.main`` and
``deploy.infer.Predictor``, cuDNN's and the matrix products' TF32 flags are
both off, whatever they were before. The flags act on the card only; here
they are read back on the CPU. Each entry point runs on a tiny float32
copy of the upstream VNetDeepSup spine recipe (the YAML with no ``dtype``)
pointed at two (16, 16, 8) volumes, with the loop, the evaluation and the
program export stubbed: what is checked is the setup. The flags are
restored after each case."""
import importlib
import os

import numpy as np
import pytest
import torch
import yaml

from medicalseg_torch import export, train, val
from medicalseg_torch.core import val as core_val
from medicalseg_torch.cvlibs.config import Config
from medicalseg_torch.deploy import infer
from medicalseg_torch.utils import strict_f32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "mri_spine_seg",
                      "vnetdeepsup_mri_spine_seg_512_512_12_15k.yml")
VOLUME = (16, 16, 8)
# the loop's module (``medicalseg_torch.core`` exports its function
# ``train`` under the same name)
core_train = importlib.import_module("medicalseg_torch.core.train")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tf32_on():
    """Both TF32 flags on for the case, restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _recipe_copy(tmp_path):
    """The recipe's YAML pointed at two seeded volumes in MRISpineSeg's
    phase0 layout, and seeded weights as ``model.pt``: (yml, weights)."""
    phase0 = tmp_path / "phase0"
    rng = np.random.RandomState(0)
    for sub in ("images", "labels"):
        (phase0 / sub).mkdir(parents=True)
    lines = []
    for i in range(2):
        name = "s{}.npy".format(i)
        np.save(str(phase0 / "images" / name),
                rng.rand(*VOLUME).astype(np.float32))
        np.save(str(phase0 / "labels" / name),
                rng.randint(0, 20, VOLUME).astype(np.uint8))
        lines.append("images/{0} labels/{0}\n".format(name))
    for split in ("train", "val"):
        (phase0 / (split + "_list.txt")).write_text("".join(lines))
    cfg = Config(RECIPE).dic
    cfg["data_root"] = str(tmp_path)
    for key in ("train_dataset", "val_dataset"):
        cfg[key]["dataset_root"] = "phase0"
        cfg[key]["result_dir"] = "phase1"
    cfg["val_dataset"]["dataset_json_path"] = ""
    yml = str(tmp_path / "recipe.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(cfg, f)
    weights = str(tmp_path / "model.pt")
    torch.save(Config(yml).model.state_dict(), weights)
    return yml, weights


def test_strict_f32_turns_both_flags_off(tf32_on):
    assert _flags() == (True, True)
    strict_f32()
    assert _flags() == (False, False)


@pytest.mark.parametrize("entry", ["train", "val", "export", "predictor"])
def test_entry_point_sets_the_f32_policy(tf32_on, tmp_path, monkeypatch,
                                         entry):
    yml, weights = _recipe_copy(tmp_path)
    seen = {}

    def record(*args, **kwargs):
        seen["flags"] = _flags()
        return {"mdice": 0.0, "mdice_hard": 0.0}

    assert _flags() == (True, True)
    if entry == "train":
        monkeypatch.setattr(core_train, "train", record)
        train.main(train.parse_args([
            "--config", yml, "--iters", "1", "--device", "cpu"]))
    elif entry == "val":
        monkeypatch.setattr(core_val, "evaluate", record)
        val.main(val.parse_args([
            "--config", yml, "--model_path", weights, "--device", "cpu"]))
    elif entry == "export":
        def export_program(net, sample, path):
            record()
            open(path, "wb").close()

        monkeypatch.setattr(export, "export_program", export_program)
        export.main(export.parse_args([
            "--config", yml, "--model_path", weights, "--device", "cpu",
            "--input_shape", "1", "1", *map(str, VOLUME),
            "--save_dir", str(tmp_path / "export")]))
    else:
        with open(str(tmp_path / "deploy.yaml"), "w") as f:
            yaml.safe_dump({"Deploy": {
                "model": "model.stablehlo", "params": "model.pt",
                "transforms": [], "output_op": "argmax",
                "input_shape_ndhwc": [1, *VOLUME, 1],
                "model_config": Config(yml).dic["model"]}}, f)
        infer.Predictor(infer.parse_args([
            "--config", str(tmp_path / "deploy.yaml"), "--image_path",
            "unused", "--device", "cpu"]))
        record()
    assert seen["flags"] == (False, False)
