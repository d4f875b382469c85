# Copyright 2026. Apache License 2.0.
"""Checkpoint save / load / resume in the JAX package's format.

Counterpart of ``medicalseg_tpu/utils/checkpoint.py``: ``iter_N/``
directories that hold ``model.msgpack`` and ``opt.msgpack``, written
through a temporary file and a rename each, the optimizer's file last (its
presence marks a resumable checkpoint); per-key, shape-checked pretrained
loading; resume that returns the iteration.

* ``model.msgpack`` holds the model's variables in the JAX package's
  layout (``{'params': ..., 'batch_stats': ...}``, moved by
  :mod:`.transplant`), so a checkpoint of either package loads into the
  other.
* ``opt.msgpack`` holds ``{'opt_state': ..., 'step': n}``. For SGD (both
  production recipes) ``opt_state`` is optax's state of the JAX package's
  optimizer, ``chain(add_decayed_weights, sgd)`` (without weight decay
  only the ``sgd`` part): the momentum as the ``trace`` tree, the update
  count as ``count``. For the other optimizers it is
  ``{'torch': <torch.save of the optimizer's state_dict>}``, which only the
  port reads.

Files are encoded by the port's own :mod:`.msgpack_codec`. A save is two
parts: a snapshot on the caller's thread (the model's variables and the
optimizer's state read back from the card into host numpy copies, a host
sync at each save point only), then the encode and the two atomic writes.
:func:`save_checkpoint` does both in turn; :func:`save_checkpoint_async`
returns once the snapshot is taken and leaves the rest to one writer thread,
which runs its jobs (writes, and whatever else :func:`submit` queues, such
as evictions) in the order they were queued, so both write the same bytes.
A failed job is not lost: the next :func:`submit` (and so the next
asynchronous save) or :func:`wait_pending_checkpoints` raises the first
failure, and the jobs queued behind it do not run, as a synchronous save
that raises stops what would follow it.
"""

import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import logger, transplant
from .msgpack_codec import pack_chunks, unpackb

MODEL_FILE = "model.msgpack"
OPT_FILE = "opt.msgpack"


_executor = None
_failure = None  # the first exception of a queued job, not yet raised
_failures = 0  # the number of queued jobs that have failed
_lock = threading.Lock()  # guards the three


def _get_executor():
    """The one worker thread that runs the queued checkpoint jobs."""
    global _executor
    with _lock:
        if _executor is None:
            _executor = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt")
        return _executor


def _take_failure():
    """Raise the first failure of a queued job since the last raise; else
    return the number of jobs that have failed."""
    global _failure
    with _lock:
        failure, _failure = _failure, None
        failures = _failures
    if failure is not None:
        raise failure
    return failures


def _guarded(fn, failures, args, kwargs):
    """Run ``fn`` unless a job queued before it failed after it was queued
    (``failures`` is the count it was queued at): an eviction or a best
    model behind a failed write does not run."""
    global _failure, _failures
    with _lock:
        if _failures > failures:
            raise RuntimeError("not run: a checkpoint job queued before it "
                               "failed")
    try:
        return fn(*args, **kwargs)
    except BaseException as e:
        with _lock:
            _failures += 1
            if _failure is None:
                _failure = e
        raise


def submit(fn, *args, **kwargs):
    """Queue ``fn(*args, **kwargs)`` on the writer thread, behind every job
    queued before it; returns its ``Future``. Raises first the failure of
    an earlier job, if one failed. A job queued behind one that fails is
    not run (its ``Future`` raises ``RuntimeError``)."""
    failures = _take_failure()
    return _get_executor().submit(_guarded, fn, failures, args, kwargs)


def wait_pending_checkpoints():
    """Block until every queued write and eviction has finished; then raise
    the first of them that failed, if one did."""
    if _executor is not None:
        _get_executor().submit(lambda: None).result()
    _take_failure()


def _atomic_write(path, data):
    """Write ``data`` (bytes, or a list of bytes-like pieces) to a
    temporary file and rename, so that an interrupted save never leaves a
    truncated file: a file is absent or complete."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for piece in [data] if isinstance(data, bytes) else data:
            f.write(piece)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read(path):
    with open(path, "rb") as f:
        return unpackb(f.read())


def _is_sgd(optimizer):
    """``torch.optim.SGD``, or its form a CUDA graph can replay: both keep
    the optax SGD layout."""
    from ..cvlibs.config import SGD
    return type(optimizer) in (torch.optim.SGD, SGD)


def _opt_state(model, optimizer, step):
    if not _is_sgd(optimizer):
        buf = io.BytesIO()
        torch.save(optimizer.state_dict(), buf)
        return {"torch": buf.getvalue()}
    sgd = {"0": {"trace": transplant.momentum_to_flax(model, optimizer)},
           "1": {"count": np.asarray(step, np.int32)}}
    if optimizer.param_groups[0]["weight_decay"]:
        return {"0": {}, "1": sgd}
    return sgd


def _find_trace(tree):
    """The ``trace`` subtree of an optax state written as nested dicts."""
    if isinstance(tree, dict):
        if "trace" in tree:
            return tree["trace"]
        for value in tree.values():
            found = _find_trace(value)
            if found is not None:
                return found
    return None


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order, as a JAX pytree map
    leaves them (the JAX package writes its trees so)."""
    if not isinstance(tree, dict):
        return tree
    return {key: _sorted(tree[key]) for key in sorted(tree)}


def snapshot(model, optimizer=None, step=None):
    """What a checkpoint of ``model`` (and ``optimizer`` at ``step``)
    holds, as host copies: (flax variables, ``opt.msgpack``'s payload or
    None), keys sorted. Every leaf is a copy, so the model may change once
    it returns; reading it back from the card waits for the work queued
    there."""
    variables = _sorted(transplant.flax_from_state_dict(model.state_dict()))
    if optimizer is None:
        return variables, None
    step = 0 if step is None else int(step)
    return variables, {"opt_state": _sorted(_opt_state(model, optimizer,
                                                       step)),
                       "step": np.asarray(step)}


def write_snapshot(save_dir, variables, payload=None):
    """Encode a :func:`snapshot` and write ``model.msgpack``, then (with a
    payload) ``opt.msgpack``, under ``save_dir``."""
    os.makedirs(save_dir, exist_ok=True)
    _atomic_write(os.path.join(save_dir, MODEL_FILE), pack_chunks(variables))
    if payload is not None:
        _atomic_write(os.path.join(save_dir, OPT_FILE), pack_chunks(payload))


def save_checkpoint(save_dir, model, optimizer=None, step=None):
    """Write ``model.msgpack`` (and, with ``optimizer``, ``opt.msgpack``
    with ``step``) under ``save_dir``."""
    write_snapshot(save_dir, *snapshot(model, optimizer, step))


def save_checkpoint_async(save_dir, model, optimizer=None, step=None):
    """:func:`save_checkpoint` with the encode and the writes on the writer
    thread: returns the write's ``Future`` once the snapshot is taken."""
    return submit(write_snapshot, save_dir,
                  *snapshot(model, optimizer, step))


def is_valid_checkpoint(path, require_opt=True):
    """True when ``path`` is a directory holding a complete checkpoint:
    ``model.msgpack``, and with ``require_opt`` also ``opt.msgpack`` (the
    file written last, so its presence marks a resumable checkpoint)."""
    if not os.path.isdir(path):
        return False
    if not os.path.exists(os.path.join(path, MODEL_FILE)):
        return False
    return not require_opt or os.path.exists(os.path.join(path, OPT_FILE))


def load_checkpoint(path, model, optimizer=None):
    """Load a checkpoint dir (or its model file) into ``model``, and with
    ``optimizer`` its optimizer state. Returns the saved step (None when
    not requested or not present)."""
    model_path = os.path.join(path, MODEL_FILE) if os.path.isdir(path) \
        else path
    if not os.path.exists(model_path):
        raise ValueError("The model file is not found: {}".format(model_path))
    state = transplant.state_dict_from_flax(_read(model_path))
    model.load_state_dict(state)
    if optimizer is None:
        return None
    opt_path = os.path.join(os.path.dirname(model_path), OPT_FILE)
    if not os.path.exists(opt_path):
        return None
    payload = _read(opt_path)
    opt_state = payload["opt_state"]
    if "torch" in opt_state:
        optimizer.load_state_dict(torch.load(
            io.BytesIO(opt_state["torch"]), weights_only=True))
    elif _is_sgd(optimizer):
        trace = _find_trace(opt_state)
        if trace is None:
            raise ValueError("{} holds no SGD momentum trace".format(opt_path))
        transplant.momentum_from_flax(model, optimizer, trace)
    else:
        raise ValueError("{} holds an optax state, which loads only into "
                         "SGD, not {}".format(opt_path,
                                              type(optimizer).__name__))
    return int(payload["step"])


def load_pretrained_model(model, pretrained_model):
    """Per-key, shape-checked weight loading from a ``model.msgpack`` of
    either package (or the directory holding it), or from a ``.pt``
    ``state_dict`` of the port: entries that are missing or shaped
    otherwise are skipped with a warning. Returns the number of entries
    loaded."""
    if pretrained_model is None:
        return 0
    if os.path.isdir(pretrained_model):
        pretrained_model = os.path.join(pretrained_model, MODEL_FILE)
    if not os.path.exists(pretrained_model):
        raise ValueError("The pretrained model directory is not found: {}".
                         format(pretrained_model))
    if pretrained_model.endswith(".pt"):
        loaded = torch.load(pretrained_model, map_location="cpu",
                            weights_only=True)
    else:
        loaded = transplant.state_dict_from_flax(_read(pretrained_model))
    own = model.state_dict()
    take = {}
    for key, value in own.items():
        if key not in loaded:
            logger.warning("{} is not in pretrained model".format(key))
        elif tuple(loaded[key].shape) != tuple(value.shape):
            logger.warning(
                "[SKIP] Shape of params {} doesn't match.(Pretrained: {}, "
                "Actual: {})".format(key, tuple(loaded[key].shape),
                                     tuple(value.shape)))
        else:
            take[key] = loaded[key]
    model.load_state_dict(take, strict=False)
    logger.info("There are {}/{} variables loaded into the model.".format(
        len(take), len(own)))
    return len(take)


def load_entire_model(model, pretrained):
    """The weights of a trained model for evaluation (the reference's
    utils.py:40-47): loads what matches, as :func:`load_pretrained_model`,
    warning of what does not. Returns ``model``."""
    if pretrained is not None:
        load_pretrained_model(model, pretrained)
    else:
        logger.warning("Not all pretrained params of {} are loaded, training "
                       "from scratch or a pretrained backbone.".format(
                           type(model).__name__))
    return model


def resume(model, optimizer, resume_model):
    """Restore the model and optimizer from ``.../iter_N`` and return N
    (the saved step, else the number in the directory's name)."""
    if resume_model is None:
        return 0
    logger.info("Resume model from {}".format(resume_model))
    if not os.path.exists(resume_model):
        raise ValueError(
            "Directory of the model needed to resume is not Found: {}".
            format(resume_model))
    step = load_checkpoint(resume_model, model, optimizer)
    return _parse_iter(resume_model) if step is None else step


def _parse_iter(path):
    tail = os.path.basename(os.path.normpath(path)).split("_")[-1]
    return int(tail) if tail.isdigit() else 0
