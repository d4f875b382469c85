"""The port's losses (medicalseg_torch.models.losses, utils.loss_utils)
against the JAX package's classes: the same logits and labels from a numpy
seed go through both, values and gradients with respect to the logits are
compared in float32 at rtol 1e-5 (sums over a few thousand voxels; atol
1e-6 for entries near zero, 1e-7 relative to the largest gradient entry).

Both packages run in their loop form (``MEDSEG_LOSS_FUSED=0``, which both
read); inputs are batched. tests/test_torch_eval.py holds the default
(fused) form to the JAX fused form.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.utils import loss_utils as jlu
from medicalseg_torch.cvlibs import manager
from medicalseg_torch.models import losses as tlosses
from medicalseg_torch.utils import loss_utils as tlu

RTOL = 1e-5
SHAPE = (2, 4, 6, 8)


@pytest.fixture(autouse=True)
def _loop_masks(monkeypatch):
    monkeypatch.setenv("MEDSEG_LOSS_FUSED", "0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(num_classes, ignore, seed=0):
    rng = np.random.RandomState(seed + num_classes)
    logits = (2 * rng.randn(*SHAPE, num_classes)).astype(np.float32)
    labels = rng.randint(0, num_classes, SHAPE).astype(np.int32)
    if ignore:
        labels[rng.rand(*SHAPE) < 0.2] = 255
    return logits, labels


def _scalar(out):
    return out[0] if isinstance(out, tuple) else out


def _compare(jloss, tloss, logits, labels):
    jval, jgrad = jax.value_and_grad(
        lambda l: _scalar(jloss(l, jnp.asarray(labels))))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tval = _scalar(tloss(tl, torch.from_numpy(labels)))
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tl.grad.numpy(), jgrad, rtol=RTOL,
                               atol=1e-7 * max(1.0, np.abs(jgrad).max()) +
                               1e-9)


CASES = [(c, i) for c in (3, 20) for i in (False, True)]
IDS = ["{}cls{}".format(c, "-ignore" if i else "") for c, i in CASES]


@pytest.mark.parametrize("num_classes,ignore", CASES, ids=IDS)
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["dynamic", "given"])
def test_cross_entropy_matches_jax(num_classes, ignore, weighted):
    logits, labels = _data(num_classes, ignore)
    weight = (list(np.linspace(0.5, 2.0, num_classes)) if weighted
              else None)
    _compare(jlosses.CrossEntropyLoss(weight=weight),
             tlosses.CrossEntropyLoss(weight=weight), logits, labels)


@pytest.mark.parametrize("num_classes,ignore", CASES, ids=IDS)
@pytest.mark.parametrize("sigmoid", [True, False],
                         ids=["sigmoid", "softmax"])
def test_dice_matches_jax(num_classes, ignore, sigmoid):
    logits, labels = _data(num_classes, ignore, seed=1)
    jl = jlosses.DiceLoss(sigmoid_norm=sigmoid)
    tl = tlosses.DiceLoss(sigmoid_norm=sigmoid)
    _compare(jl, tl, logits, labels)
    jpcd = np.asarray(jl(jnp.asarray(logits), jnp.asarray(labels))[1])
    tpcd = tl(torch.from_numpy(logits), torch.from_numpy(labels))[1]
    assert tpcd.shape == (num_classes,)
    np.testing.assert_allclose(tpcd.numpy(), jpcd, rtol=RTOL, atol=1e-7)


def test_dice_weight_and_ignored_voxels_leave_all_three_sums():
    logits, labels = _data(3, True, seed=2)
    w = [0.5, 1.0, 2.0]
    _compare(jlosses.DiceLoss(weight=w), tlosses.DiceLoss(weight=w), logits,
             labels)
    # changing the logits of ignored voxels changes nothing
    tl = tlosses.DiceLoss()
    a = tl(torch.from_numpy(logits), torch.from_numpy(labels))[0]
    moved = logits.copy()
    moved[labels == 255] += 7.0
    b = tl(torch.from_numpy(moved), torch.from_numpy(labels))[0]
    assert a.item() == b.item()
    ce = tlosses.CrossEntropyLoss(weight=[1.0, 1.0, 1.0])
    assert (ce(torch.from_numpy(logits), torch.from_numpy(labels)).item() ==
            ce(torch.from_numpy(moved), torch.from_numpy(labels)).item())


def test_dice_rejects_float_labels_and_shape_mismatch():
    logits, labels = _data(3, False)
    with pytest.raises(TypeError, match="int"):
        tlosses.DiceLoss()(torch.from_numpy(logits),
                           torch.from_numpy(labels).float())
    with pytest.raises(ValueError, match="same shape"):
        tlosses.DiceLoss().compute_per_channel_dice(
            torch.zeros(1, 2, 2, 2, 3), torch.zeros(1, 2, 2, 2, 4))
    with pytest.raises(ValueError, match="number of weights"):
        tlosses.CrossEntropyLoss(weight=[1.0, 2.0])(
            torch.from_numpy(logits), torch.from_numpy(labels))


def test_compute_per_channel_dice_matches_jax_one_hot_form():
    rng = np.random.RandomState(3)
    probs = rng.rand(2, 3, 4, 5, 3).astype(np.float32)
    target = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 3, 4, 5))]
    ref = jlosses.DiceLoss().compute_per_channel_dice(jnp.asarray(probs),
                                                      jnp.asarray(target))
    got = tlosses.DiceLoss().compute_per_channel_dice(
        torch.from_numpy(probs), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("num_classes", [3, 20])
def test_class_weights_and_flatten_match_jax(num_classes):
    logits, _ = _data(num_classes, False, seed=4)
    ref = np.asarray(jlosses.class_weights(jnp.asarray(logits)))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.class_weights(tl)
    assert not got.requires_grad  # stop_gradient
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)
    np.testing.assert_array_equal(
        tlosses.flatten(torch.from_numpy(logits)).numpy(),
        np.asarray(jlosses.flatten(jnp.asarray(logits))))


@pytest.mark.parametrize("weight,pos_weight", [
    (None, None), ("dynamic", None), (None, "dynamic"), (None, 2.5),
    ("dynamic", "dynamic")])
@pytest.mark.parametrize("ignore", [False, True], ids=["all", "ignore"])
def test_bce_matches_jax(weight, pos_weight, ignore):
    logits, labels = _data(3, ignore, seed=5)
    _compare(jlosses.BCELoss(weight=weight, pos_weight=pos_weight),
             tlosses.BCELoss(weight=weight, pos_weight=pos_weight), logits,
             labels)


def test_bce_dense_labels_and_bad_strings():
    logits, _ = _data(3, False, seed=6)
    dense = np.random.RandomState(6).randint(0, 2, logits.shape).astype(
        np.float32)
    ref = jlosses.BCELoss()(jnp.asarray(logits), jnp.asarray(dense))
    got = tlosses.BCELoss()(torch.from_numpy(logits),
                            torch.from_numpy(dense))
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    with pytest.raises(ValueError, match="dynamic"):
        tlosses.BCELoss(weight="static")
    with pytest.raises(ValueError, match="dynamic"):
        tlosses.BCELoss(pos_weight="static")


@pytest.mark.parametrize("num_classes,ignore", CASES, ids=IDS)
def test_mixed_loss_and_loss_computation_match_jax(num_classes, ignore):
    """The lung recipe's loss: MixedLoss(CE(weight=None) + Dice), coef
    [1, 1], through loss_computation: the loss list, its sum's gradient
    and the per-channel dice."""
    logits, labels = _data(num_classes, ignore, seed=7)
    jcfg = {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1, 0.5])],
        "coef": [2]}
    tcfg = {"types": [tlosses.MixedLoss(
        [tlosses.CrossEntropyLoss(), tlosses.DiceLoss()], [1, 0.5])],
        "coef": [2]}

    def jtotal(l):
        ll, pcd = jlu.loss_computation([l], jnp.asarray(labels), jcfg)
        return sum(ll), (ll, pcd)

    (jval, (jll, jpcd)), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tll, tpcd = tlu.loss_computation([tl], torch.from_numpy(labels), tcfg)
    assert len(tll) == len(jll) == 2
    sum(tll).backward()
    for a, b in zip(tll, jll):
        np.testing.assert_allclose(a.item(), float(b), rtol=RTOL)
    np.testing.assert_allclose(tpcd.detach().numpy(), np.asarray(jpcd),
                               rtol=RTOL, atol=1e-7)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tl.grad.numpy(), jgrad, rtol=RTOL,
                               atol=1e-7 * np.abs(jgrad).max() + 1e-9)


def test_loss_computation_contracts():
    logits, labels = _data(3, False, seed=8)
    tl, tb = torch.from_numpy(logits), torch.from_numpy(labels)
    dice = {"types": [tlosses.DiceLoss()], "coef": [0.4]}
    ll, pcd = tlu.loss_computation([tl], tb, dice)
    assert len(ll) == 1 and pcd.shape == (3,)
    np.testing.assert_allclose(ll[0].item(),
                               0.4 * tlosses.DiceLoss()(tl, tb)[0].item(),
                               rtol=1e-6)
    ce = {"types": [tlosses.CrossEntropyLoss()] * 2, "coef": [1, 0.5]}
    ll, pcd = tlu.loss_computation([tl, tl], tb, ce)
    assert len(ll) == 2 and pcd is None
    with pytest.raises(RuntimeError, match="length of logits_list"):
        tlu.loss_computation([tl, tl], tb, dice)
    edge = {"types": [tlosses.BCELoss(edge_label=True)], "coef": [1]}
    edges = torch.from_numpy((labels > 0).astype(np.int64))
    ll, _ = tlu.loss_computation([tl[..., :1]], tb, edge,
                                 edges=edges[..., None].float())
    assert torch.isfinite(ll[0])


def test_mixed_loss_validates_and_losses_are_registered():
    with pytest.raises(TypeError):
        tlosses.MixedLoss((tlosses.DiceLoss(),), [1])
    with pytest.raises(TypeError):
        tlosses.MixedLoss([tlosses.DiceLoss()], (1,))
    with pytest.raises(ValueError, match="length"):
        tlosses.MixedLoss([tlosses.DiceLoss()], [1, 2])
    for name in ("CrossEntropyLoss", "DiceLoss", "MixedLoss", "BCELoss"):
        assert manager.LOSSES[name] is getattr(tlosses, name)
