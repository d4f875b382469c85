"""The port's evaluation stack against the JAX package's, on the CPU: the
metrics (medicalseg_torch.utils.metric), the fused loss form, ``evaluate``
(medicalseg_torch.core.val), the val CLI (``python -m
medicalseg_torch.val``) and evaluation during training with the best-model
tracker and the tensorboardX writer.

Sizes are small: a V-Net of 2 classes on
``tools/generate_synthetic_dataset.generate(size=16, num_volumes=4)`` with
two val volumes (as tests/test_eval_extras.py builds it, labels made
binary, dataset.json geometry moved off the identity), its weights moved
into the port by ``utils.transplant``; the sliding window (``sw_num=2``)
on the same at size 32, so that its 16^3 windows fit V-Net's four
stride-2 levels (the 8^3 windows of a 16^3 volume leave the fourth down
conv a 1^3 input for its 2^3 kernel: the JAX model runs on through
flax's zero-extent shapes, the port's convs refuse); the spine fixture of
tests/test_torch_train_loop.py for the loop. Float32 throughout. Each JAX
``evaluate`` mode runs once a module and every case shares it.

Tolerances: losses at rtol 1e-5 in value and gradient (sums of a few
thousand voxels in another order; gradients also atol 1e-7 of their
largest entry); evaluate's mDice, argmax mDice, loss and AUC at rtol 1e-4
(two f32 forwards of 16 convs each, summed in other orders), dumped
predictions equal; metric counts exact, their aggregates at 1e-12. The
loss of the 32^3 sliding-window case at rtol 1e-3: the JAX
CrossEntropyLoss sums 32768 voxels in float32 one after another on the
CPU (bound 32768 * 2^-24 = 2e-3; on the logits of this case it is 3.4e-4
from a float64 sum, the port 2e-7).
"""
import glob
import json
import logging
import os
import sys

import numpy as np
import pytest
import yaml

import flax
import jax
import jax.numpy as jnp
import optax
import torch

from medicalseg_tpu.core import evaluate as jevaluate
from medicalseg_tpu.core.state import TrainState as JTrainState
from medicalseg_tpu.datasets import MedicalDataset as JMedicalDataset
from medicalseg_tpu.models import VNet as JVNet
from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.utils import checkpoint as jckpt
from medicalseg_tpu.utils import loss_utils as jlu
from medicalseg_tpu.utils import metric as jmetric
from medicalseg_tpu.utils import quant as jquant
from medicalseg_torch import io as medio
from medicalseg_torch import val as val_cli
from medicalseg_torch.core.state import TrainState
from medicalseg_torch.core.train import train
from medicalseg_torch.core.val import evaluate
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.datasets import MedicalDataset
from medicalseg_torch.models import VNet
from medicalseg_torch.models import losses as tlosses
from medicalseg_torch.utils import metric, quant, transplant
from medicalseg_torch.utils import loss_utils as tlu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.generate_synthetic_dataset import generate  # noqa: E402
from test_torch_train_loop import _spine_yaml, _write_dataset  # noqa: E402

RTOL_LOSS = 1e-5
RTOL_EVAL = 1e-4
RTOL_EVAL_LOSS_32 = 1e-3
GEOMETRY = {"spacing_resample": [0.8, 1.25, 2.0],
            "origin": [-3.0, 5.5, 12.0],
            "direction": [1, 0, 0, 0, 1, 0, 0, 0, 1]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Lines(logging.Handler):
    """The messages of a package's logger while in a ``with`` block."""

    def __init__(self, name):
        super().__init__()
        self.logger = logging.getLogger(name)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

    def loss(self):
        line = [ln for ln in self.lines if "[EVAL] #Images" in ln][-1]
        return float(line.split("Loss: ")[1].split()[0])


# --------------------------------------------------------------------------
# (a) metrics
# --------------------------------------------------------------------------
@pytest.mark.parametrize("classes", [2, 3, 5])
def test_metric_functions_match_jax(classes):
    rng = np.random.RandomState(classes)
    pred = rng.randint(0, classes, (2, 6, 7, 8)).astype(np.int32)
    label = rng.randint(0, classes, (2, 6, 7, 8)).astype(np.int32)
    label[rng.rand(*label.shape) < 0.1] = 255
    ref = [np.asarray(a) for a in jmetric.calculate_area(
        jnp.asarray(pred), jnp.asarray(label), classes)]
    got = metric.calculate_area(torch.from_numpy(pred),
                                torch.from_numpy(label), classes)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int64 and a.shape == (classes,)
        np.testing.assert_array_equal(a.numpy(), b)
    # a singleton channel axis of 4-D inputs is squeezed, as in JAX
    squeezed = metric.calculate_area(torch.from_numpy(pred[0][:, None]),
                                     torch.from_numpy(label[0]), classes)
    ref_sq = jmetric.calculate_area(jnp.asarray(pred[0][:, None]),
                                    jnp.asarray(label[0]), classes)
    for a, b in zip(squeezed, ref_sq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    areas = [a.numpy() for a in got]
    for name, n in (("mean_iou", 3), ("dice", 3), ("kappa", 3),
                    ("accuracy", 2)):
        want = getattr(jmetric, name)(*ref[:n])
        have = getattr(metric, name)(*areas[:n])
        np.testing.assert_allclose(_flat(have), _flat(want), rtol=1e-12,
                                   err_msg=name)
    with pytest.raises(ValueError, match="should be equal"):
        metric.calculate_area(torch.zeros(2, 3), torch.zeros(3, 2), classes)


def _flat(x):
    return np.hstack(x if isinstance(x, tuple) else (x,))


@pytest.mark.parametrize("classes", [2, 3])
def test_auc_roc_matches_jax_with_ties(classes):
    """The JAX function is scikit-learn's roc_auc_score; scores drawn from
    a few rows so that many voxels tie."""
    rng = np.random.RandomState(10 + classes)
    rows = rng.rand(6, classes)
    rows /= rows.sum(1, keepdims=True)
    scores = rows[rng.randint(0, 6, (3, 5, 4, 4))]  # N, D, H, W, C
    scores = np.moveaxis(scores, -1, 1)  # N, C, D, H, W
    label = rng.randint(0, classes, (3, 1, 5, 4, 4))
    want = jmetric.auc_roc(scores, label, num_classes=classes)
    got = metric.auc_roc(scores, label, num_classes=classes)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    with pytest.raises(RuntimeError, match="ignore_index"):
        metric.auc_roc(scores, label, num_classes=classes, ignore_index=255)
    extra = label.copy()
    extra.flat[0] = classes + 5  # one label more than there are classes
    with pytest.raises(RuntimeError, match="ignore_index"):
        metric.auc_roc(scores, extra, num_classes=classes)


# --------------------------------------------------------------------------
# (b, c) the fused loss form
# --------------------------------------------------------------------------
SHAPE = (2, 4, 6, 8)


def _loss_data(classes, seed, shape=SHAPE):
    """Logits and labels with ignored voxels and labels outside [0, C)."""
    rng = np.random.RandomState(seed + classes)
    logits = (2 * rng.randn(*shape, classes)).astype(np.float32)
    labels = rng.randint(0, classes, shape).astype(np.int32)
    labels[rng.rand(*shape) < 0.15] = 255
    labels[rng.rand(*shape) < 0.05] = classes + 2
    labels[rng.rand(*shape) < 0.05] = -1
    return logits, labels


def _value_and_grad_jax(fn, logits, labels):
    def scalar(l):
        out = fn(l, jnp.asarray(labels))
        return out[0] if isinstance(out, tuple) else out
    value, grad = jax.value_and_grad(scalar)(jnp.asarray(logits))
    return float(value), np.asarray(grad)


def _value_and_grad_torch(fn, logits, labels):
    tl = torch.from_numpy(logits).requires_grad_(True)
    out = fn(tl, torch.from_numpy(labels))
    value = out[0] if isinstance(out, tuple) else out
    value.backward()
    return value.item(), tl.grad.numpy()


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL_LOSS)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL_LOSS,
                               atol=1e-7 * np.abs(want[1]).max() + 1e-9)


LOSS_CASES = [
    ("ce-dynamic", lambda m, c: m.CrossEntropyLoss()),
    ("ce-weights", lambda m, c: m.CrossEntropyLoss(
        weight=list(np.linspace(0.5, 2.0, c)))),
    ("dice-sigmoid", lambda m, c: m.DiceLoss()),
    ("dice-softmax", lambda m, c: m.DiceLoss(sigmoid_norm=False)),
    ("dice-weights", lambda m, c: m.DiceLoss(
        weight=list(np.linspace(2.0, 0.5, c)))),
    ("mixed", lambda m, c: _mixed(m)),
]


def _mixed(m):
    mixed = m.MixedLoss([m.CrossEntropyLoss(), m.DiceLoss()], [1, 0.5])
    lu = jlu if m is jlosses else tlu

    def fn(logits, labels):
        loss_list, pcd = lu.loss_computation([logits], labels, {
            "types": [mixed], "coef": [2]})
        return sum(loss_list), pcd
    return fn


@pytest.mark.parametrize("classes", [3, 20])
@pytest.mark.parametrize("name,make", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_fused_losses_match_the_jax_fused_form(monkeypatch, name, make,
                                               classes):
    monkeypatch.setenv("MEDSEG_LOSS_FUSED", "1")
    logits, labels = _loss_data(classes, seed=1)
    want = _value_and_grad_jax(make(jlosses, classes), logits, labels)
    got = _value_and_grad_torch(make(tlosses, classes), logits, labels)
    _assert_same(got, want)
    if name.startswith(("dice", "mixed")):  # the per-channel dice too
        jpcd = make(jlosses, classes)(jnp.asarray(logits),
                                      jnp.asarray(labels))[1]
        tpcd = make(tlosses, classes)(torch.from_numpy(logits),
                                      torch.from_numpy(labels))[1]
        np.testing.assert_allclose(tpcd.numpy(), np.asarray(jpcd),
                                   rtol=RTOL_LOSS, atol=1e-7)


@pytest.mark.parametrize("name,make", LOSS_CASES[:5],
                         ids=[c[0] for c in LOSS_CASES[:5]])
def test_fused_losses_on_unbatched_logits_equal_the_loop_form(
        monkeypatch, name, make):
    """4-D logits: the port's fused form against its loop form and the JAX
    loop form (the JAX fused Dice is wrong there; ROADMAP section 3)."""
    logits, labels = _loss_data(3, seed=2, shape=SHAPE[1:])
    monkeypatch.setenv("MEDSEG_LOSS_FUSED", "0")
    want = _value_and_grad_jax(make(jlosses, 3), logits, labels)
    loop = _value_and_grad_torch(make(tlosses, 3), logits, labels)
    monkeypatch.setenv("MEDSEG_LOSS_FUSED", "1")
    fused = _value_and_grad_torch(make(tlosses, 3), logits, labels)
    _assert_same(loop, want)
    _assert_same(fused, want)
    _assert_same(fused, loop)


def test_the_switch_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("MEDSEG_LOSS_FUSED", raising=False)
    assert tlosses.loss_utils.fused_masks()
    monkeypatch.setenv("MEDSEG_LOSS_FUSED", "0")
    assert not tlosses.loss_utils.fused_masks()


# --------------------------------------------------------------------------
# (d) evaluate against the JAX evaluate
# --------------------------------------------------------------------------
def _write_val_root(root, size):
    """Four volumes of ``size``^3, two of them val, labels binary;
    dataset.json with a geometry off the identity."""
    phase0 = generate(str(root), num_volumes=4, size=size, seed=0,
                      num_classes=2, val_frac=0.5)
    for f in os.listdir(os.path.join(phase0, "labels")):
        p = os.path.join(phase0, "labels", f)
        np.save(p, (np.load(p) > 0).astype(np.int32))
    json_path = os.path.join(os.path.dirname(phase0), "synthetic_raw",
                             "dataset.json")
    with open(json_path) as f:
        meta = json.load(f)
    for entry in meta["training"].values():
        entry.update(GEOMETRY)
    with open(json_path, "w") as f:
        json.dump(meta, f)
    return phase0, json_path


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    return _write_val_root(tmp_path_factory.mktemp("data"), 16)


@pytest.fixture(scope="module")
def val_root32(tmp_path_factory):
    return _write_val_root(tmp_path_factory.mktemp("data32"), 32)


def _datasets(val_root):
    phase0, json_path = val_root
    kw = dict(dataset_root=phase0, result_dir=phase0, transforms=[],
              num_classes=2, mode="val", dataset_json_path=json_path)
    return JMedicalDataset(**kw), MedicalDataset(**kw)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX V-Net (2 classes) at 16^3 with non-trivial BN statistics."""
    model = JVNet(in_channels=1, num_classes=2)
    state = JTrainState.create(model, optax.sgd(1e-3),
                               jnp.zeros((1, 16, 16, 16, 1)),
                               jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(jax.device_get(state.batch_stats)))
    return state.replace(batch_stats=stats)


def _losses(module):
    return {"types": [module.MixedLoss([module.CrossEntropyLoss(),
                                        module.DiceLoss()], [1.0, 1.0])],
            "coef": [1]}


def _run_jax(state, dataset, save_dir, **kw):
    with _Lines("medicalseg_tpu") as log:
        result = jevaluate(state, dataset, _losses(jlosses),
                           save_dir=save_dir, **kw)
    return result, log.loss()


@pytest.fixture(scope="module")
def jax_runs(val_root, val_root32, jax_state, tmp_path_factory):
    """The JAX evaluate, once per mode: whole volumes with AUC-ROC, and the
    sliding window with sw_num=2 at size 32. The JAX dataset object of the
    whole volumes is kept: it caches the compiled evaluation."""
    runs = {"jds": _datasets(val_root)[0]}
    for mode, jds, kw in (("whole", runs["jds"], {"auc_roc": True}),
                          ("sw2", _datasets(val_root32)[0], {"sw_num": 2})):
        out = str(tmp_path_factory.mktemp("jax_" + mode))
        runs[mode] = _run_jax(jax_state, jds, out, **kw) + (out,)
    return runs


def _port_state(jax_state):
    model = VNet(in_channels=1, num_classes=2)
    model.load_state_dict(transplant.state_dict_from_flax(
        {"params": jax.device_get(jax_state.params),
         "batch_stats": jax_state.batch_stats}))
    return TrainState(model, None, None, None, step=0)


def _assert_result(result, loss, want, want_loss, auc,
                   rtol_loss=RTOL_EVAL):
    for key in ("mdice", "mdice_hard") + (("auc_roc",) if auc else ()):
        np.testing.assert_allclose(result[key], want[key], rtol=RTOL_EVAL,
                                   err_msg=key)
    assert ("auc_roc" in result) == auc
    np.testing.assert_allclose(loss, want_loss, rtol=rtol_loss)


def _assert_dumps(got_dir, want_dir, volumes, size=16):
    for i in range(volumes):
        for name in ("pred", "label", "img"):
            a = np.load(os.path.join(got_dir, str(i), name + ".npy"))
            b = np.load(os.path.join(want_dir, str(i), name + ".npy"))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
            _, got_meta = medio.read_image(
                os.path.join(got_dir, str(i), name + ".nii.gz"))
            data, want_meta = medio.read_image(
                os.path.join(want_dir, str(i), name + ".nii.gz"))
            np.testing.assert_allclose(got_meta["spacing"],
                                       want_meta["spacing"], rtol=1e-6)
            np.testing.assert_allclose(got_meta["origin"],
                                       want_meta["origin"], rtol=1e-6)
            np.testing.assert_allclose(got_meta["spacing"],
                                       GEOMETRY["spacing_resample"],
                                       rtol=1e-6)
            assert data.shape == (size,) * 3


@pytest.mark.parametrize("mode", ["whole", "sw2", "auc"])
def test_evaluate_matches_jax(val_root, val_root32, jax_state, jax_runs,
                              tmp_path, mode):
    want, want_loss, want_dir = jax_runs["sw2" if mode == "sw2" else
                                         "whole"]
    _, tds = _datasets(val_root32 if mode == "sw2" else val_root)
    state = _port_state(jax_state)
    state.model.train()
    with _Lines("medicalseg_torch") as log:
        result = evaluate(state, tds, _losses(tlosses),
                          auc_roc=mode == "auc",
                          sw_num=2 if mode == "sw2" else None,
                          save_dir=str(tmp_path))
    assert state.model.training  # the train mode is restored
    _assert_result(result, log.loss(), want, want_loss, mode == "auc",
                   RTOL_EVAL_LOSS_32 if mode == "sw2" else RTOL_EVAL)
    assert sum("[EVAL]" in ln for ln in log.lines) == 3
    _assert_dumps(str(tmp_path), want_dir, len(tds),
                  32 if mode == "sw2" else 16)


# --------------------------------------------------------------------------
# (e) the val CLI
# --------------------------------------------------------------------------
def _val_yaml(tmp_path, val_root):
    phase0, json_path = val_root
    cfg = {"batch_size": 1, "iters": 10,
           "val_dataset": {"type": "MedicalDataset", "dataset_root": phase0,
                           "result_dir": phase0, "num_classes": 2,
                           "transforms": [], "mode": "val",
                           "dataset_json_path": json_path},
           "optimizer": {"type": "sgd", "momentum": 0.9},
           "lr_scheduler": {"type": "PolynomialDecay",
                            "learning_rate": 0.001, "decay_steps": 10,
                            "end_lr": 0, "power": 0.9},
           "loss": {"types": [{"type": "MixedLoss", "losses": [
               {"type": "CrossEntropyLoss", "weight": None},
               {"type": "DiceLoss"}], "coef": [1, 1]}], "coef": [1]},
           "model": {"type": "VNet", "in_channels": 1, "num_classes": 2}}
    path = str(tmp_path / "val.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _jax_rounded(params, precision):
    params = jax.device_get(params)
    if precision == "int8":
        return jquant.dequantize_tree(jquant.quantize_tree(params))
    if precision == "bf16":
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16).astype(x.dtype),
                            params)
    return params


@pytest.mark.parametrize("precision,auc", [("fp32", False), ("fp32", True),
                                           ("int8", False), ("bf16", False)],
                         ids=["fp32", "auc", "int8", "bf16"])
def test_val_cli_on_a_jax_checkpoint(val_root, jax_state, jax_runs,
                                     tmp_path, precision, auc):
    """The port's CLI on a model.msgpack written by the JAX package reports
    the JAX evaluate's numbers; with --weights_precision, those of the JAX
    evaluate on the JAX CLI's rounded params, which equal the port's."""
    jckpt.save_checkpoint(str(tmp_path / "ckpt"),
                          {"params": jax_state.params,
                           "batch_stats": jax_state.batch_stats})
    args = val_cli.parse_args([
        "--config", _val_yaml(tmp_path, val_root), "--model_path",
        str(tmp_path / "ckpt" / "model.msgpack"), "--save_dir",
        str(tmp_path / "out"), "--weights_precision", precision,
        "--auc_roc", str(auc), "--device", "cpu"])
    assert val_cli.parse_args([]).device == "cuda"
    with _Lines("medicalseg_torch") as log:
        result = val_cli.main(args)
    if precision == "fp32":
        want, want_loss, want_dir = jax_runs["whole"]
        _assert_result(result, log.loss(), want, want_loss, auc)
        _assert_dumps(str(tmp_path / "out"), want_dir, 2)
        return
    rounded = _jax_rounded(jax_state.params, precision)
    want, want_loss = _run_jax(jax_state.replace(params=rounded),
                               jax_runs["jds"], str(tmp_path / "jax"))
    _assert_result(result, log.loss(), want, want_loss, False)
    # the port's rounded leaves are the JAX CLI's
    model = tconfig.Config(args.cfg).model
    model.load_state_dict(transplant.state_dict_from_flax(
        {"params": jax.device_get(jax_state.params),
         "batch_stats": jax_state.batch_stats}))
    quant.round_trip_parameters(model, precision)
    got = transplant.flax_from_state_dict(model.state_dict())["params"]
    leaves = jax.tree_util.tree_leaves_with_path(rounded)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got)) > 50
    for (path, want_leaf), got_leaf in zip(
            leaves, jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(got_leaf, np.asarray(want_leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_val_cli_errors(tmp_path, val_root):
    with pytest.raises(RuntimeError, match="No configuration file"):
        val_cli.main(val_cli.parse_args(["--device", "cpu"]))
    empty = os.path.join(str(tmp_path), "empty")
    os.makedirs(empty)
    open(os.path.join(empty, "val_list.txt"), "w").close()
    path = _val_yaml(tmp_path, (empty, ""))
    with pytest.raises(ValueError, match="length of val_dataset is 0"):
        val_cli.main(val_cli.parse_args(["--config", path, "--device",
                                         "cpu"]))


# --------------------------------------------------------------------------
# (f) evaluation during training
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spine_data(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("spine")), (8, 32, 32),
                          3, 20)


def test_train_evaluates_keeps_the_best_model_and_resumes_it(
        tmp_path, spine_data, monkeypatch):
    """Two iterations with an eval each: ``best_model/`` and ``best.json``
    are written, and the writer's event file. A run resumed from ``iter_1``
    restores the tracker, so a worse eval there leaves the best model
    alone (a tracker reset to -1 would overwrite it)."""
    path = _spine_yaml(tmp_path, spine_data)
    out = tmp_path / "out"

    def run(iters, **kw):
        cfg = tconfig.Config(path, iters=iters)
        return train(cfg.model, cfg.train_dataset,
                     val_dataset=cfg.val_dataset,
                     optimizer=cfg.build_optimizer,
                     lr_scheduler=cfg.lr_scheduler, save_dir=str(out),
                     iters=iters, batch_size=1, losses=cfg.loss,
                     log_iters=1, save_interval=1, seed=0, device="cpu",
                     **kw)

    with _Lines("medicalseg_torch") as log:
        run(2, use_vdl=True)
    evals = [ln for ln in log.lines if "[EVAL] #Images: 3" in ln]
    assert len(evals) == 2
    with open(out / "best_model" / "best.json") as f:
        best = json.load(f)
    assert best["iter"] in (1, 2) and np.isfinite(best["mdice"])
    weights = (out / "best_model" / "model.msgpack").read_bytes()
    assert glob.glob(str(out / "events.out.tfevents*"))
    for i in range(3):  # the eval's dump of the val volumes
        assert os.path.exists(out / str(i) / "pred.nii.gz")

    core_train = sys.modules["medicalseg_torch.core.train"]
    monkeypatch.setattr(core_train, "evaluate",
                        lambda *a, **kw: {"mdice": -0.5, "mdice_hard": 0.0})
    with _Lines("medicalseg_torch") as log:
        state = run(3, resume_model=str(out / "iter_2"))
    assert state.step == 3
    assert any("Restored best-model tracker" in ln for ln in log.lines)
    with open(out / "best_model" / "best.json") as f:
        assert json.load(f) == best
    assert (out / "best_model" / "model.msgpack").read_bytes() == weights
