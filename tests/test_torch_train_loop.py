"""The port's data path and training loop on the CPU: the loader
(medicalseg_torch.core.loader) against the JAX package's, the prefetcher,
Config's datasets and pretrained weights, ``core.train`` with checkpoints,
eviction and resume, and the train CLI (``python -m
medicalseg_torch.train``) on the flagship recipe.

Sizes are small: volumes of the spine geometry (8, 32, 32), the flagship
YAML cut to float32, no remat and batch 1. The loader's batches are
compared exactly, and so is the resumed state with the saved one (float32
values round-trip through msgpack unchanged).
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

import torch

from medicalseg_tpu.core import loader as jloader
from medicalseg_tpu.datasets import MedicalDataset as JMedicalDataset
from medicalseg_tpu.transforms import RandomFlip3D as JRandomFlip3D
from medicalseg_torch.core import loader as tloader
from medicalseg_torch.core.prefetch import DevicePrefetcher
from medicalseg_torch.core.state import TrainState
from medicalseg_torch.core.train import train
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.datasets import MedicalDataset
from medicalseg_torch.transforms import RandomFlip3D
from medicalseg_torch.utils import checkpoint as tckpt
from medicalseg_torch.utils import transplant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPINE = os.path.join(ROOT, "configs", "synthetic",
                     "vnetdeepsup_synspine_15k.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_dataset(root, shape, n, classes, seed=0):
    """``n`` seeded volumes and labels as .npy with train/val list files;
    returns the phase0 directory."""
    phase0 = os.path.join(root, "phase0")
    os.makedirs(os.path.join(phase0, "images"), exist_ok=True)
    os.makedirs(os.path.join(phase0, "labels"), exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        np.save(os.path.join(phase0, "images", "v{}.npy".format(i)),
                (rng.rand(*shape) * 255).astype(np.float32))
        np.save(os.path.join(phase0, "labels", "v{}.npy".format(i)),
                rng.randint(0, classes, shape).astype(np.uint8))
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    for name in ("train_list.txt", "val_list.txt"):
        with open(os.path.join(phase0, name), "w") as f:
            f.writelines(lines)
    return phase0


@pytest.fixture(scope="module")
def spine_data(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("spine")), (8, 32, 32),
                          3, 20)


# --------------------------------------------------------------------------
# loader and prefetcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_loader_yields_the_jax_loaders_sequence(spine_data, seed):
    jds = JMedicalDataset(spine_data, spine_data, [JRandomFlip3D()], 20,
                          repeat_train=3)
    tds = MedicalDataset(spine_data, spine_data, [RandomFlip3D()], 20,
                         repeat_train=3)
    assert tds.file_list == jds.file_list and len(tds) == 9
    ref = jloader.TrainLoader(jds, batch_size=2, num_workers=1, seed=seed,
                              mode="device", wire_dtype="float32")
    ours = tloader.TrainLoader(tds, batch_size=2, num_workers=1, seed=seed,
                               mode="device", wire_dtype="float32")
    wire = tloader.TrainLoader(tds, batch_size=2, num_workers=1, seed=seed,
                               mode="device", wire_dtype="bfloat16")
    try:
        assert ours.mode == "device"
        for _ in range(7):  # across an epoch boundary (9 items)
            images, labels = next(ref)
            got_images, got_labels = next(ours)
            np.testing.assert_array_equal(got_images.numpy(), images)
            np.testing.assert_array_equal(got_labels.numpy(), labels)
            w_images, w_labels = next(wire)
            assert w_images.dtype == torch.bfloat16
            assert w_labels.dtype == torch.uint8
            assert torch.equal(w_images, torch.from_numpy(
                np.asarray(images, np.float32)).to(torch.bfloat16))
            np.testing.assert_array_equal(w_labels.numpy(), labels)
    finally:
        ref.stop()
        ours.stop()
        wire.stop()


def test_host_mode_runs_compose(spine_data):
    from medicalseg_torch.transforms import BinaryMaskToConnectComponent
    tds = MedicalDataset(spine_data, spine_data,
                         [BinaryMaskToConnectComponent()], 20)
    # a transform with no device implementation: auto picks host mode
    tds.transforms.transforms = [RandomFlip3D()]
    loader = tloader.TrainLoader(tds, batch_size=2, num_workers=2)
    try:
        assert loader.mode == "host"
        images, labels = next(loader)
        assert images.shape == (2, 8, 32, 32, 1)
        assert float(images.max()) <= 1.0
        assert labels.shape == (2, 8, 32, 32)
    finally:
        loader.stop()


def test_loader_device_cache_mode_on_the_spine_data(spine_data):
    """``auto`` holds the three (8, 32, 32) volumes on the device: the
    loader yields index vectors into ``unique_pairs`` (each volume once,
    though the list repeats it ten times), and ``build_device_cache`` holds
    the volumes the ``device`` mode would ship, in the same wire dtypes."""
    tds = MedicalDataset(spine_data, spine_data, [RandomFlip3D()], 20)
    cached = tloader.TrainLoader(tds, batch_size=2, num_workers=1, seed=0,
                                 wire_dtype="bfloat16")
    device = tloader.TrainLoader(tds, batch_size=2, num_workers=1, seed=0,
                                 mode="device", wire_dtype="bfloat16")
    try:
        assert cached.mode == "device_cache" and len(tds) == 30
        assert len(cached.unique_pairs) == 3
        images, labels = cached.build_device_cache("cpu")
        assert images.shape == labels.shape == (3, 8, 32, 32)
        for _ in range(4):
            idx = next(cached)
            want_images, want_labels = next(device)
            assert idx.dtype == np.int32 and idx.shape == (2,)
            assert torch.equal(images[idx], want_images)
            assert torch.equal(labels[idx], want_labels)
    finally:
        cached.stop()
        device.stop()


def test_eval_loader_yields_the_jax_loaders_items(spine_data):
    jds = JMedicalDataset(spine_data, spine_data, [], 20, mode="val")
    tds = MedicalDataset(spine_data, spine_data, [], 20, mode="val")
    ref = list(jloader.EvalLoader(jds, start=1))
    got = list(tloader.EvalLoader(tds, start=1))
    assert len(got) == len(ref) == 2
    for (im, lab, i), (jim, jlab, j) in zip(got, ref):
        assert i == j and im.shape == (1, 8, 32, 32, 1)
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(lab, jlab)


def test_datasets_refuse_to_download():
    from medicalseg_torch.datasets import LungCoronavirus, MRISpineSeg
    for cls in (LungCoronavirus, MRISpineSeg):
        with pytest.raises(NotImplementedError,
                           match="medicalseg_torch.tools.prepare_"):
            cls(num_classes=3)


def test_prefetcher_order_values_and_errors():
    items = [(torch.full((4,), float(i)), torch.arange(i + 1))
             for i in range(5)]
    got = list(DevicePrefetcher(iter(items), "cpu"))
    assert len(got) == 5
    for (a, b), (x, y) in zip(got, items):
        assert torch.equal(a, x) and torch.equal(b, y)

    def produce():
        yield (torch.zeros(2),)
        raise ValueError("boom")

    pf = DevicePrefetcher(produce(), "cpu")
    next(pf)
    with pytest.raises(ValueError, match="boom"):
        next(pf)
    pf.close()


# --------------------------------------------------------------------------
# Config, the loop, resume and the CLI
# --------------------------------------------------------------------------
def _spine_yaml(tmp_path, phase0, **model):
    """The flagship YAML pointing at ``phase0``, cut for the CPU: float32,
    no remat, batch 1 (``model`` overrides more keys)."""
    with open(SPINE) as f:
        cfg = yaml.safe_load(f)
    cfg["data_root"] = os.path.dirname(phase0)
    for key in ("train_dataset", "val_dataset"):
        cfg[key]["dataset_root"] = "phase0"
        cfg[key]["result_dir"] = "phase1"
    cfg["batch_size"] = 1
    cfg["model"].update({"dtype": "float32", "remat": False, **model})
    path = str(tmp_path / "spine.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_config_builds_datasets_classes_and_pretrained(tmp_path, spine_data):
    path = _spine_yaml(tmp_path, spine_data)
    cfg = tconfig.Config(path)
    ds = cfg.train_dataset
    assert isinstance(ds, MedicalDataset) and len(ds) == 30  # x10 repeat
    assert ds.dataset_root == spine_data
    assert [type(t).__name__ for t in ds.raw_transforms] == [
        "RandomRotation3D", "RandomFlip3D"]
    assert cfg.val_dataset.mode == "val" and len(cfg.val_dataset) == 3

    model = cfg.model
    tckpt.save_checkpoint(str(tmp_path / "pre"), model)
    dic = cfg.dic["model"]
    dic.pop("num_classes")  # taken from the train dataset
    dic["pretrained"] = str(tmp_path / "pre")
    again = tconfig.Config(path)
    again.dic["model"] = dic
    loaded = again.model
    assert loaded.out_tr.conv2.weight.shape[0] == 20
    for (name, a), b in zip(loaded.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name


def _leaves(tree, prefix=""):
    """(path, leaf) of a tree of nested dicts, in key order."""
    out = []
    for key in sorted(tree):
        name = prefix + "/" + key
        if isinstance(tree[key], dict):
            out.extend(_leaves(tree[key], name))
        else:
            out.append((name, tree[key]))
    return out


def _state_numbers(state):
    moved = transplant.flax_from_state_dict(state.model.state_dict())
    return (moved, transplant.momentum_to_flax(state.model, state.optimizer),
            state.step)


def test_save_dir_made_by_another_rank_meanwhile_is_kept(tmp_path,
                                                         monkeypatch):
    """Every rank prepares ``save_dir`` at once: where another rank makes
    the directory just after this one first looked (the first ``stat`` of
    the path finds nothing, and the directory exists from then on), the
    directory is kept, not removed as a stray file; a stray file is
    replaced by a directory."""
    save_dir = str(tmp_path / "out")
    real_stat, looked = os.stat, []

    def stat(path, *args, **kwargs):
        if os.fspath(path) == save_dir and not looked:
            looked.append(path)
            os.mkdir(save_dir)  # the other rank
            raise FileNotFoundError(path)
        return real_stat(path, *args, **kwargs)

    monkeypatch.setattr(os, "stat", stat)
    core_train = sys.modules["medicalseg_torch.core.train"]
    core_train._make_save_dir(save_dir)
    assert looked and os.path.isdir(save_dir)
    monkeypatch.undo()
    stray = str(tmp_path / "stray")
    open(stray, "w").close()
    core_train._make_save_dir(stray)
    assert os.path.isdir(stray)


@pytest.mark.parametrize("async_checkpoint", [False, True],
                         ids=["sync", "async"])
def test_train_saves_evicts_and_resumes_exactly(tmp_path, spine_data,
                                               monkeypatch, async_checkpoint):
    """Four iterations, a checkpoint every two, one kept: only ``iter_4``
    is left. Each save is also copied aside with the numbers of the state
    it saved, and a run resumed from the copy of ``iter_2`` (taking no
    step) holds those numbers exactly: parameters, BatchNorm statistics,
    momentum and step. With ``async_checkpoint`` the saves are written on
    the writer thread, and the copy is queued behind the write (and ahead
    of the eviction)."""
    path = _spine_yaml(tmp_path, spine_data)
    saved = {}

    def spy(save_dir, model, optimizer, step):
        copy = tmp_path / "copies" / str(step)
        if async_checkpoint:
            tckpt.save_checkpoint_async(save_dir, model, optimizer, step)
            tckpt.submit(shutil.copytree, save_dir, copy)
        else:
            tckpt.save_checkpoint(save_dir, model, optimizer, step)
            shutil.copytree(save_dir, copy)
        state = TrainState(model, optimizer, None, None, step)
        saved[step] = _state_numbers(state)

    monkeypatch.setattr(sys.modules["medicalseg_torch.core.train"],
                        "save_checkpoint_async" if async_checkpoint
                        else "save_checkpoint", spy)

    def run(iters, save_dir, **kw):
        cfg = tconfig.Config(path, iters=iters)
        return train(cfg.model, cfg.train_dataset,
                     optimizer=cfg.build_optimizer,
                     lr_scheduler=cfg.lr_scheduler, save_dir=save_dir,
                     iters=iters, batch_size=cfg.batch_size, losses=cfg.loss,
                     log_iters=2, seed=0, device="cpu",
                     async_checkpoint=async_checkpoint, **kw)

    final = run(4, str(tmp_path / "a"), save_interval=2,
                keep_checkpoint_max=1)
    assert os.listdir(tmp_path / "a") == ["iter_4"] and final.step == 4
    assert sorted(saved) == [2, 4]
    resumed = run(2, str(tmp_path / "b"),
                  resume_model=str(tmp_path / "copies" / "2"))
    assert not os.path.exists(tmp_path / "b" / "iter_2")  # no step taken
    (v0, m0, s0), (v1, m1, s1) = saved[2], _state_numbers(resumed)
    assert s0 == s1 == 2
    for tree0, tree1 in ((v0, v1), (m0, m1)):
        pairs = list(zip(_leaves(tree0), _leaves(tree1)))
        assert len(pairs) > 100
        for (name, a), (_, b) in pairs:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert v0["batch_stats"]  # the BatchNorm statistics were compared
    # the unbroken run moved on from there
    assert not np.array_equal(saved[4][1]["Conv_0"]["kernel"],
                              m0["Conv_0"]["kernel"])


def test_cli_dispatches_cached_steps_and_profiles(tmp_path, spine_data):
    """The CLI with ``--loader_mode device_cache --steps_per_dispatch 2
    --profiler_options``: four iterations in two dispatches, both logged,
    a checkpoint that loads, and a trace of iterations 1-3."""
    path = _spine_yaml(tmp_path, spine_data)
    out, trace = tmp_path / "out", tmp_path / "trace"
    cmd = [sys.executable, "-m", "medicalseg_torch.train", "--config", path,
           "--iters", "4", "--save_interval", "4", "--log_iters", "2",
           "--save_dir", str(out), "--seed", "0", "--device", "cpu",
           "--loader_mode", "device_cache", "--steps_per_dispatch", "2",
           "--profiler_options", "batch_range=[1,3];profile_path={};"
           "exit_on_finished=false".format(trace)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TrainLoader mode: device_cache" in proc.stdout
    lines = [ln for ln in proc.stdout.splitlines() if "[TRAIN]" in ln]
    assert len(lines) == 2 and "iter: 4/4" in lines[-1]
    losses = [float(ln.split("loss: ")[1].split(",")[0]) for ln in lines]
    assert all(np.isfinite(losses))
    assert os.path.getsize(trace / "trace.json") > 0
    model = tconfig.Config(path).model
    optimizer = tconfig.SGD(model.parameters(), lr=0.01, momentum=0.9)
    assert tckpt.load_checkpoint(str(out / "iter_4"), model, optimizer) == 4


def test_cli_trains_the_flagship_recipe_on_the_cpu(tmp_path, spine_data):
    path = _spine_yaml(tmp_path, spine_data)
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "medicalseg_torch.train", "--config", path,
           "--iters", "2", "--save_interval", "2", "--log_iters", "1",
           "--keep_checkpoint_max", "1", "--save_dir", str(out), "--seed",
           "0", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if "[TRAIN]" in ln]
    assert len(lines) == 2 and "iter: 2/2" in lines[-1]
    losses = [float(ln.split("loss: ")[1].split(",")[0]) for ln in lines]
    assert all(np.isfinite(losses))
    assert os.listdir(out) == ["iter_2"]
    model = tconfig.Config(path).model
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    assert tckpt.load_checkpoint(str(out / "iter_2"), model, optimizer) == 2



def test_cli_rejects_tpu_only_flags(capsys):
    """``--space`` sizes the process mesh now: it parses, and a space axis
    larger than the world is refused when the mesh is built (one process
    here; tests/test_torch_parallel.py trains over two)."""
    from medicalseg_torch.parallel import build_mesh
    from medicalseg_torch.train import parse_args
    assert parse_args(["--space", "1"]).device == "cuda"
    assert parse_args(["--space", "2"]).space == 2
    with pytest.raises(ValueError, match="space=2"):
        build_mesh(space=2)
