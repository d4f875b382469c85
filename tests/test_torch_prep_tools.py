"""The port's offline prep tools (``medicalseg_torch/tools/prepare*.py``,
``preprocess_utils``) against the JAX package's (``tools/``) on the CPU.

Each case builds a raw dataset twice, one copy for each package, runs
both ``Prep`` pipelines and compares what they write: the ``.npy``
volumes (labels exactly; images exactly with the host backend, where both
run the same numpy / scipy code, and within 1e-5 of the image's largest
magnitude with the device backend, where the JAX ops and the port's torch
ops sum the resize's taps in float32 in other orders), the list files and
``dataset.json`` (the image paths, which name each copy, made relative).
The device backend's torch ops run on the CPU (``set_device('cpu')``);
the fixture is tests/test_prep_tools.py's: four 10 x 12 x 14 NIfTI
volumes.
"""
import functools
import json
import os
import os.path as osp
import shutil
import sys
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from medicalseg_tpu import io as jio
from medicalseg_torch.tools import preprocess_utils as tpu_
from medicalseg_torch.utils import download as tdownload

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import preprocess_utils as jpu  # noqa: E402

IMG_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _remove_outputs(tmp_path):
    """Each case writes up to a few hundred MB of volumes: gone after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture()
def backend():
    """set(use_device): both packages' switch, the port's device backend on
    the CPU; restored afterwards."""
    saved = jpu.use_device(), tpu_.use_device(), tpu_.global_var["device"]

    def set_(flag):
        jpu.set_use_device(flag)
        tpu_.set_use_device(flag)
        tpu_.set_device("cpu")

    yield set_
    jpu.set_use_device(saved[0])
    tpu_.set_use_device(saved[1])
    tpu_.set_device(saved[2])


def _write_pairs(img_dir, lab_dir, names, rng, label_names=None, suffix=
                 ".nii.gz", classes=3, lo=-1200, hi=600):
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    for i, name in enumerate(names):
        img = (rng.rand(10, 12, 14) * (hi - lo) + lo).astype(np.float32)
        lab = rng.randint(0, classes, (10, 12, 14)).astype(np.int32)
        jio.write_image(osp.join(img_dir, name + suffix), img,
                        spacing=(1.0, 1.0, 2.0))
        jio.write_image(osp.join(lab_dir, (label_names or names)[i] + suffix),
                        lab, spacing=(1.0, 1.0, 2.0))


def _relative(tree, root):
    """``tree`` with every string under ``root`` made relative to it."""
    if isinstance(tree, dict):
        return {k: _relative(v, root) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_relative(v, root) for v in tree]
    if isinstance(tree, str) and tree.startswith(root):
        return osp.relpath(tree, root)
    return tree


def _assert_same_outputs(jax_root, port_root, exact):
    """Every file under the two roots: the same names, the same ``.npy``
    volumes, list files and JSON."""
    def files(root):
        return sorted(osp.relpath(osp.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(jax_root)
    assert names == files(port_root)
    npys = [n for n in names if n.endswith(".npy")]
    assert npys
    for name in names:
        a, b = osp.join(jax_root, name), osp.join(port_root, name)
        if name.endswith(".npy"):
            ref, got = np.load(a), np.load(b)
            assert got.dtype == ref.dtype and got.shape == ref.shape, name
            if ref.dtype.kind != "f" or exact:
                np.testing.assert_array_equal(got, ref, err_msg=name)
            else:
                np.testing.assert_allclose(
                    got, ref, rtol=0, atol=IMG_REL * np.abs(ref).max(),
                    err_msg=name)
        elif name.endswith(".json"):
            with open(a) as f:
                ref = _relative(json.load(f), jax_root)
            with open(b) as f:
                got = _relative(json.load(f), port_root)
            assert got == ref, name
        elif name.endswith(".txt"):
            assert open(a).read() == open(b).read(), name


def _wp(func, **kw):
    p = functools.partial(func, **kw)
    functools.update_wrapper(p, func)
    return p


@pytest.mark.parametrize("device", [False, True])
def test_prep_pipeline_matches_jax(tmp_path, backend, device):
    """The pipeline of tests/test_prep_tools.py: dataset.json, HUnorm +
    resample to 8^3 (labels order 0), the 80/20 lists."""
    from tools.prepare import Prep as JPrep
    from medicalseg_torch.tools.prepare import Prep as TPrep
    backend(device)
    roots = {}
    for side, cls, pu in (("jax", JPrep, jpu), ("port", TPrep, tpu_)):
        root = str(tmp_path / side)
        _write_pairs(osp.join(root, "raw", "imgs"),
                     osp.join(root, "raw", "labs"),
                     ["case_{:02d}".format(i) for i in range(4)],
                     np.random.RandomState(0))
        prep = cls(dataset_root=root, raw_dataset_dir="raw",
                   images_dir="imgs", labels_dir="labs", phase_dir="phase0",
                   urls=None, valid_suffix=("nii.gz",),
                   filter_key=(None, None))
        assert len(prep.image_files) == len(prep.label_files) == 4
        prep.generate_dataset_json(modalities=("CT",),
                                   labels={0: "bg", 1: "a", 2: "b"},
                                   dataset_name="fake")
        prep.load_save(preprocess={
            "images": [pu.HUnorm, _wp(pu.resample, new_shape=[8, 8, 8],
                                      order=1)],
            "labels": [_wp(pu.resample, new_shape=[8, 8, 8], order=0)]})
        img_npys = sorted(os.listdir(prep.image_path))
        lab_npys = sorted(os.listdir(prep.label_path))
        for txt in ("train_list.txt", "val_list.txt"):
            prep.split_files_txt(osp.join(prep.phase_path, txt), img_npys,
                                 lab_npys)
        roots[side] = root
    _assert_same_outputs(roots["jax"], roots["port"], exact=not device)


def _lung(root, rng):
    raw = osp.join(root, "lung_coronavirus_raw")
    names = ["coronacases_org_00{}".format(i) for i in range(1, 5)]
    _write_pairs(osp.join(raw, "20_ncov_scan"), osp.join(raw, "lung_mask"),
                 names, rng, [n.replace("_org_", "_") for n in names])
    return {"dataset_root": root}


def _spine(root, rng):
    raw = osp.join(root, "MRI_spine_seg_raw", "train")
    names = ["Case{}".format(i) for i in range(1, 4)]
    _write_pairs(osp.join(raw, "MR"), osp.join(raw, "Mask"), names, rng,
                 ["mask_case{}".format(i) for i in range(1, 4)], classes=21,
                 lo=0, hi=3000)
    return {"dataset_root": root}


def _msd(root, rng):
    task = "Task04_Hippocampus"
    base = osp.join(root, "data", task, task + "_raw", task)
    _write_pairs(osp.join(base, "imagesTr"), osp.join(base, "labelsTr"),
                 ["hippocampus_00{}".format(i) for i in range(1, 5)], rng)
    # the Decathlon's hidden "._" copies, which the filter drops
    for sub in ("imagesTr", "labelsTr"):
        open(osp.join(base, sub, "._hippocampus_001.nii.gz"), "wb").close()
    with open(osp.join(base, "dataset.json"), "w") as f:
        json.dump({"name": "Hippocampus", "modality": {"0": "MRI"},
                   "labels": {"0": "background", "1": "Anterior",
                              "2": "Posterior"}}, f)
    return {"task_id": 4}


def _promise12(root, rng):
    raw = osp.join(root, "data", "Promise12", "Promise12_raw", "prostate")
    for part, cases in (("TrainingData_Part1", (0, 1)),
                        ("TrainingData_Part2", (2,)),
                        ("TrainingData_Part3", (3,))):
        names = ["Case{:02d}".format(i) for i in cases]
        _write_pairs(osp.join(raw, part), osp.join(raw, part), names, rng,
                     [n + "_segmentation" for n in names], suffix=".mhd",
                     classes=2, lo=0, hi=1000)
    test = osp.join(raw, "TestData")
    os.makedirs(test)
    jio.write_image(osp.join(test, "Case30.mhd"),
                    (rng.rand(10, 12, 14) * 1000).astype(np.float32))
    return {"addr": "Promise12"}


def _prostate_mri(root, rng):
    raw = osp.join(root, "data", "Prostate_mri", "Prostate_mri_raw",
                   "Processed_data_nii")
    for site, cases in (("BIDMC", (0,)), ("UCL", (1, 2))):
        names = ["Case{:02d}".format(i) for i in cases]
        _write_pairs(osp.join(raw, site), osp.join(raw, site), names, rng,
                     [n + "_segmentation" for n in names], classes=2,
                     lo=0, hi=1000)
    return {"addr": "Prostate_mri"}


def _run_script(module, kwargs, profile):
    """What each script's ``__main__`` does, on the raw data in the
    current directory."""
    if "addr" in kwargs:
        prep = module.Prep_prostate(module.DATASET_ADDR[kwargs["addr"]])
        prep.generate_dataset_json(**module.DATASET_PROFILE[kwargs["addr"]])
    else:
        cls = next(getattr(module, n) for n in dir(module)
                   if n.startswith("Prep_"))
        prep = cls(**kwargs)
        if "task_id" in kwargs:
            profile = module.parse_msd_basic_info(osp.join(
                osp.dirname(prep.image_dir), "dataset.json"))
            prep.generate_dataset_json(*profile)
        else:
            prep.generate_dataset_json(**profile)
    prep.load_save(preprocess=prep.preprocess)
    prep.generate_txt()
    return prep


@pytest.mark.parametrize("script,build,extra", [
    ("prepare_lung_coronavirus", _lung, {"download": False}),
    ("prepare_mri_spine_seg", _spine, {"download": False}),
    ("prepare_msd", _msd, {"download": False}),
    ("prepare_prostate", _promise12, {}),
    ("prepare_prostate", _prostate_mri, {})])
def test_prepare_scripts_match_jax(tmp_path, backend, monkeypatch, script,
                                   build, extra):
    """Each ``prepare_*`` script's recipe on its raw directory layout,
    built locally (the JAX script with its download off, the port's with
    no archive), with the device backend: the same files, volumes, lists
    and dataset.json."""
    import importlib
    backend(True)
    profile = {"modalities": ("CT",), "labels": {0: "bg", 1: "a"},
               "dataset_name": "fake"}
    roots = {}
    for side, package in (("jax", "tools."), ("port",
                                              "medicalseg_torch.tools.")):
        root = str(tmp_path / side)
        os.makedirs(root)
        kwargs = build(root, np.random.RandomState(4))
        if side == "jax":
            kwargs.update(extra)
        monkeypatch.chdir(root)  # msd and prostate: paths under data/
        module = importlib.import_module(package + script)
        prep = _run_script(module, kwargs, profile)
        assert prep.image_files and len(prep.image_files) == len(
            prep.label_files)
        roots[side] = root
    monkeypatch.chdir(ROOT)
    _assert_same_outputs(roots["jax"], roots["port"], exact=False)


@pytest.mark.parametrize("form", ["zip", "tar_file_url"])
def test_local_archives_are_extracted(tmp_path, backend, form):
    """The port's lung script on its four archives placed under the
    dataset root (zip), or given as file:// URLs (tar): the same outputs
    as from the extracted directories."""
    from medicalseg_torch.tools import prepare_lung_coronavirus as lung
    backend(False)
    src = str(tmp_path / "src")
    _lung(src, np.random.RandomState(4))
    raw = osp.join(src, "lung_coronavirus_raw")
    root = str(tmp_path / "root")
    os.makedirs(root)
    archives = []
    for name, sub in (("20_ncov_scan.zip", "20_ncov_scan"),
                      ("Lung_Mask.zip", "lung_mask")):
        path = osp.join(root, name) if form == "zip" else osp.join(
            src, name.replace(".zip", ".tar"))
        if form == "zip":
            with zipfile.ZipFile(path, "w") as z:
                for f in sorted(os.listdir(osp.join(raw, sub))):
                    z.write(osp.join(raw, sub, f), osp.join(sub, f))
        else:
            with tarfile.open(path, "w") as t:
                t.add(osp.join(raw, sub), sub)
            archives.append("file://" + path)
    profile = {"modalities": ("CT",), "labels": {0: "bg", 1: "a"},
               "dataset_name": "fake"}
    _run_script(lung, {"dataset_root": root,
                       "archives": None if form == "zip" else archives},
                profile)
    shutil.rmtree(osp.join(src, "lung_coronavirus_raw"))
    _lung(src, np.random.RandomState(4))
    _run_script(lung, {"dataset_root": src}, profile)
    for d in ("lung_coronavirus_phase0",):
        _assert_same_outputs(osp.join(src, d), osp.join(root, d), exact=True)


def test_network_urls_raise_and_the_device_needs_a_gpu(tmp_path, backend):
    """A URL that is neither a local path nor file:// raises before any
    connection is tried; with the device switch on and ``cuda`` asked for,
    the ops raise where there is no GPU."""
    from medicalseg_torch.tools.prepare import Prep
    with pytest.raises(ValueError, match="file://"):
        tdownload.local_path("https://example.invalid/Lung_Mask.zip")
    assert tdownload.local_path("file:///data/a.zip") == "/data/a.zip"
    with pytest.raises(ValueError, match="file://"):
        Prep(dataset_root=str(tmp_path), raw_dataset_dir="raw",
             urls={"a.zip": "https://example.invalid/a.zip"})
    assert not osp.exists(osp.join(str(tmp_path), "a.zip"))
    backend(True)
    tpu_.set_device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpu_.HUnorm(np.zeros((2, 2, 2), np.float32))
