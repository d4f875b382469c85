"""The port's asynchronous checkpoint writes (medicalseg_torch.utils.
checkpoint: the snapshot on the caller's thread, the encode and the writes
on one writer thread) on the CPU: the same bytes as the synchronous save
and as the JAX package's asynchronous writer, a snapshot taken at call
time, failures that are raised and not lost, ``is_valid_checkpoint``
against the JAX function, and ``core.train`` leaving the same files both
ways.

V-Net with 2 classes (its widths are fixed, so the tree is full size); the
optimizers' state comes from one update on seeded gradients, no train
step. The loop runs the flagship YAML cut to float32, no remat, batch 1 and
(8, 16, 16) volumes. Files are compared by their bytes' sha256, and
removed after each test.
"""
import concurrent.futures
import hashlib
import os
import shutil
import threading

import numpy as np
import pytest
import yaml

import torch

from medicalseg_tpu.utils import checkpoint as jckpt
from medicalseg_torch.core.train import train
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.models import VNet
from medicalseg_torch.utils import checkpoint as tckpt
from medicalseg_torch.utils import transplant
from medicalseg_torch.utils.msgpack_codec import unpackb

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


@pytest.fixture(scope="module")
def model():
    """One port V-Net for the module (its construction takes seconds);
    tests that change it restore it."""
    return VNet(num_classes=2, dropout=False,
                generator=torch.Generator().manual_seed(1))


def _stepped(model, kind):
    """An optimizer of ``kind`` over ``model`` after one update on seeded
    gradients (the parameters are put back, the optimizer keeps its
    state)."""
    params = list(model.parameters())
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=1e-3)
    else:
        opt = tconfig.SGD(params, lr=0.01, momentum=0.9,
                          weight_decay=1e-4 if kind == "sgd-wd" else 0.0)
    gen = torch.Generator().manual_seed(3)
    saved = [p.detach().clone() for p in params]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    with torch.no_grad():
        for p, v in zip(params, saved):
            p.copy_(v)
            p.grad = None
    return opt


@pytest.fixture(autouse=True)
def _free_the_disk(tmp_path):
    """A checkpoint here is hundreds of MB, and pytest keeps the temporary
    directories of recent runs: remove each test's files after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _digest(path):
    """sha256 of a file's bytes, read in pieces."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(1 << 24), b""):
            h.update(piece)
    return h.hexdigest()


@pytest.mark.parametrize("kind", ["sgd", "sgd-wd", "adam"])
def test_async_and_sync_saves_write_the_same_bytes(tmp_path, model, kind):
    opt = _stepped(model, kind)
    tckpt.save_checkpoint(str(tmp_path / "sync"), model, opt, 7)
    future = tckpt.save_checkpoint_async(str(tmp_path / "async"), model, opt,
                                         7)
    tckpt.wait_pending_checkpoints()
    assert future.done() and future.exception() is None
    for name in (tckpt.MODEL_FILE, tckpt.OPT_FILE):
        assert _digest(tmp_path / "sync" / name) == \
            _digest(tmp_path / "async" / name), name
    payload = unpackb(_bytes(tmp_path / "async" / tckpt.OPT_FILE))
    assert int(payload["step"]) == 7
    assert ("torch" in payload["opt_state"]) == (kind == "adam")


def test_async_model_file_is_the_jax_writers_bytes(tmp_path, model):
    """The JAX package's ``save_checkpoint_async`` of the transplanted
    variables writes the bytes the port's writer does."""
    variables = transplant.flax_from_state_dict(model.state_dict())
    jckpt.save_checkpoint_async(str(tmp_path / "jax"), variables)
    jckpt.wait_pending_checkpoints()
    tckpt.save_checkpoint_async(str(tmp_path / "port"), model)
    tckpt.wait_pending_checkpoints()
    assert _digest(tmp_path / "jax" / tckpt.MODEL_FILE) == \
        _digest(tmp_path / "port" / tckpt.MODEL_FILE)
    assert not os.path.exists(tmp_path / "port" / tckpt.OPT_FILE)


def test_snapshot_is_taken_at_call_time(tmp_path, model):
    """The writer is held back until the parameters, BatchNorm statistics
    and momentum have changed in place: the files hold the values of the
    call."""
    opt = _stepped(model, "sgd")
    before = tckpt.snapshot(model, opt, 1)
    gate = threading.Event()
    tckpt.submit(gate.wait)
    future = tckpt.save_checkpoint_async(str(tmp_path / "c"), model, opt, 1)
    saved = [v.detach().clone() for v in model.state_dict().values()]
    try:
        with torch.no_grad():
            for v in model.state_dict().values():
                if v.is_floating_point():
                    v.add_(1.0)
            for state in opt.state.values():
                state["momentum_buffer"].add_(1.0)
        changed = tckpt.snapshot(model, opt, 1)
        assert not future.done()
    finally:
        gate.set()
        tckpt.wait_pending_checkpoints()
        with torch.no_grad():
            for v, old in zip(model.state_dict().values(), saved):
                v.copy_(old)
    for name, want, moved in zip((tckpt.MODEL_FILE, tckpt.OPT_FILE), before,
                                 changed):
        got = _leaves(unpackb(_bytes(tmp_path / "c" / name)))
        assert len(got) > 50
        for (key, a), (_, b), (_, c) in zip(got, _leaves(want),
                                            _leaves(moved)):
            np.testing.assert_array_equal(a, b, err_msg=key)
            if a.dtype == np.float32:  # the values did move on
                assert not np.array_equal(a, c), key


def _leaves(tree, prefix=""):
    """(path, leaf) of a tree of nested dicts, in key order."""
    out = []
    for key in sorted(tree):
        name = prefix + "/" + key
        if isinstance(tree[key], dict):
            out.extend(_leaves(tree[key], name))
        else:
            out.append((name, np.asarray(tree[key])))
    return out


@pytest.mark.parametrize("where", ["at-wait", "at-next-save"])
def test_a_failed_write_raises_once(tmp_path, model, where):
    """A write into a path that is a file fails on the writer thread; its
    exception is raised by the wait, or by the next save (which then
    queues nothing), once, and the writer goes on."""
    blocker = tmp_path / "file"
    blocker.write_bytes(b"not a directory")
    future = tckpt.save_checkpoint_async(str(blocker), model)
    concurrent.futures.wait([future])
    assert isinstance(future.exception(), OSError)
    good = tmp_path / "good"
    if where == "at-wait":
        with pytest.raises(OSError):
            tckpt.wait_pending_checkpoints()
    else:
        with pytest.raises(OSError):
            tckpt.save_checkpoint_async(str(good), model)
        assert not good.exists()
    tckpt.wait_pending_checkpoints()  # raised once: nothing left
    tckpt.save_checkpoint_async(str(good), model).result()
    assert tckpt.is_valid_checkpoint(str(good), require_opt=False)


@pytest.mark.parametrize("files", [("model", "opt"), ("model",), ("opt",),
                                   (), "missing", "a-file"])
@pytest.mark.parametrize("require_opt", [True, False])
def test_is_valid_checkpoint_agrees_with_jax(tmp_path, files, require_opt):
    path = tmp_path / "iter_5"
    if files == "a-file":
        path.write_bytes(b"")
    elif files != "missing":
        path.mkdir()
        for name in files:
            (path / "{}.msgpack".format(name)).write_bytes(b"")
    want = jckpt.is_valid_checkpoint(str(path), require_opt=require_opt)
    assert tckpt.is_valid_checkpoint(str(path), require_opt=require_opt) \
        == want
    assert want == (files == ("model", "opt") or
                    (files == ("model",) and not require_opt))


def _tree(root):
    """{relative path: sha256} of every checkpoint file under ``root``
    (``iter_*/`` and ``best_model/``; the evaluation's dumps are gzip
    files that hold their own time)."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            full = os.path.join(base, name)
            rel = os.path.relpath(full, root)
            if rel.startswith(("iter_", "best_model")):
                out[rel] = _digest(full)
    return out


def _spine_yaml(tmp_path):
    """The flagship YAML cut to float32, no remat, batch 1, over one train
    and one val volume of (8, 16, 16); returns its path."""
    phase0 = tmp_path / "data" / "phase0"
    rng = np.random.RandomState(0)
    for i in range(2):
        for kind, arr in (("images", rng.rand(8, 16, 16).astype(np.float32)),
                          ("labels", rng.randint(0, 20, (8, 16, 16))
                           .astype(np.uint8))):
            os.makedirs(phase0 / kind, exist_ok=True)
            np.save(phase0 / kind / "v{}.npy".format(i), arr)
    for name, i in (("train_list.txt", 0), ("val_list.txt", 1)):
        with open(phase0 / name, "w") as f:
            f.write("images/v{0}.npy labels/v{0}.npy\n".format(i))
    with open(SPINE) as f:
        cfg = yaml.safe_load(f)
    cfg["data_root"] = str(tmp_path / "data")
    for key in ("train_dataset", "val_dataset"):
        cfg[key]["dataset_root"] = "phase0"
        cfg[key]["result_dir"] = "phase1"
    cfg["batch_size"] = 1
    cfg["model"].update({"dtype": "float32", "remat": False})
    path = str(tmp_path / "spine.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_train_leaves_the_same_files_async_and_sync(tmp_path):
    """Three iterations, a save and an evaluation at each, two checkpoints
    kept: ``iter_2``, ``iter_3``, ``best_model/`` with ``best.json``, the
    same files and bytes with and without ``async_checkpoint``."""
    path = _spine_yaml(tmp_path)
    trees = []
    for async_checkpoint in (True, False):
        config = tconfig.Config(path, iters=3)
        out = str(tmp_path / "out_{}".format(async_checkpoint))
        train(config.model, config.train_dataset, config.val_dataset,
              optimizer=config.build_optimizer,
              lr_scheduler=config.lr_scheduler, save_dir=out, iters=3,
              batch_size=1, save_interval=1, log_iters=1,
              losses=config.loss, keep_checkpoint_max=2, seed=0,
              device="cpu", async_checkpoint=async_checkpoint)
        trees.append(_tree(out))
    got, want = trees
    assert sorted(got) == sorted(want) == sorted(
        ["iter_2/model.msgpack", "iter_2/opt.msgpack", "iter_3/model.msgpack",
         "iter_3/opt.msgpack", "best_model/model.msgpack",
         "best_model/best.json"])
    for name in got:
        assert got[name] == want[name], name


@pytest.mark.parametrize("async_checkpoint", [True, False],
                         ids=["async", "sync"])
def test_a_failed_save_evicts_nothing(tmp_path, async_checkpoint):
    """Two iterations, a save at each, one checkpoint kept, and ``iter_2``
    a path that is a file: its write fails and ``train`` raises it, and
    ``iter_1``, the only resumable checkpoint, is still there, whole (the
    eviction queued behind the failed write does not run)."""
    path = _spine_yaml(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    (out / "iter_2").write_bytes(b"not a directory")
    config = tconfig.Config(path, iters=2)
    with pytest.raises(OSError):
        train(config.model, config.train_dataset,
              optimizer=config.build_optimizer,
              lr_scheduler=config.lr_scheduler, save_dir=str(out), iters=2,
              batch_size=1, save_interval=1, log_iters=1,
              losses=config.loss, keep_checkpoint_max=1, seed=0,
              device="cpu", async_checkpoint=async_checkpoint)
    tckpt.wait_pending_checkpoints()  # raised once: nothing left
    assert tckpt.is_valid_checkpoint(str(out / "iter_1"))
    assert int(unpackb(_bytes(out / "iter_1" / tckpt.OPT_FILE))["step"]) == 1
    assert unpackb(_bytes(out / "iter_1" / tckpt.MODEL_FILE))["params"]


def test_a_leg_resumes_from_the_newest_complete_checkpoint(tmp_path,
                                                           capsys):
    """``tools/train_legs.py`` passes over an ``iter_N`` that a SIGTERM
    left without ``opt.msgpack`` (or with only a ``.tmp`` file) and takes
    the newest complete one; its command line prints the CLI's
    ``--resume_model`` for it, and nothing when there is none."""
    from medicalseg_torch.tools.train_legs import main, newest_checkpoint
    assert newest_checkpoint(str(tmp_path / "none")) is None
    main([str(tmp_path / "none")])
    assert capsys.readouterr().out == ""
    for it, names in ((500, ("model", "opt")), (1000, ("model", "opt")),
                      (1500, ("model",)), (2000, ())):
        d = tmp_path / "iter_{}".format(it)
        d.mkdir()
        for name in names:
            (d / "{}.msgpack".format(name)).write_bytes(b"")
    (tmp_path / "iter_2000" / "model.msgpack.tmp").write_bytes(b"")
    (tmp_path / "iter_x").mkdir()
    (tmp_path / "best_model").mkdir()
    assert newest_checkpoint(str(tmp_path)) == str(tmp_path / "iter_1000")
    main([str(tmp_path)])
    assert capsys.readouterr().out.split() == [
        "--resume_model", str(tmp_path / "iter_1000")]


def test_jobs_from_many_threads_run_on_one_writer_in_order():
    """Sixteen threads (more than the cores) queue jobs at once with a
    short switch interval: every job runs, all on one writer thread, each
    thread's jobs in the order it queued them."""
    import sys
    ran, idents = [], set()

    def job(thread, i):
        idents.add(threading.get_ident())
        ran.append((thread, i))

    def queue(thread):
        for i in range(20):
            tckpt.submit(job, thread, i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=queue, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    tckpt.wait_pending_checkpoints()
    assert len(idents) == 1 and len(ran) == 16 * 20
    for t in range(16):
        assert [i for th, i in ran if th == t] == list(range(20))


@pytest.mark.parametrize("where", ["at-wait", "at-next-submit"])
def test_jobs_behind_a_failed_job_do_not_run(where):
    """A job fails with two more queued behind it: they do not run (their
    futures raise), the failure is raised once, by the wait or the next
    submit, and the jobs queued after that run."""
    ran = []
    gate = threading.Event()
    tckpt.submit(gate.wait)

    def fail():
        raise ValueError("the write")

    failed = tckpt.submit(fail)
    behind = [tckpt.submit(ran.append, i) for i in range(2)]
    gate.set()
    concurrent.futures.wait(behind)
    assert isinstance(failed.exception(), ValueError)
    for future in behind:
        assert isinstance(future.exception(), RuntimeError)
    with pytest.raises(ValueError, match="the write"):
        if where == "at-wait":
            tckpt.wait_pending_checkpoints()
        else:
            tckpt.submit(ran.append, "lost")
    tckpt.submit(ran.append, "after").result()
    tckpt.wait_pending_checkpoints()  # raised once: nothing left
    assert ran == ["after"]


def test_the_loop_error_goes_on_past_a_failed_write():
    """While ``train`` unwinds from an error of its own, the wait for the
    writer logs a failed write instead of raising it over that error."""
    from medicalseg_torch.core.train import _wait_writer

    def fail():
        raise OSError("the write")

    tckpt.submit(fail)
    _wait_writer(raise_failure=False)
    tckpt.wait_pending_checkpoints()  # logged, not kept
    tckpt.submit(fail)
    with pytest.raises(OSError, match="the write"):
        _wait_writer(raise_failure=True)
