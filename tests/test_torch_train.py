"""The port's train step (medicalseg_torch.core.state) against the JAX
package's ``make_train_step`` itself, following
tests/test_train_dynamics_oracle.py: VNet, 2 classes, (2, 16, 16, 16, 1),
dropout off, weights carried across by utils/transplant.py, the recipe's
loss (MixedLoss(CE + Dice)), SGD with momentum, coupled weight decay and a
polynomial schedule.

Tolerances are the oracle test's: iteration-0 loss rtol 2e-4 and gradients
atol 5e-4 / rtol 5e-3 at every leaf (float32; 16 convs of up to 125 * 256
products each, summed in another order), the 5-step loss trajectory within
1e-3 relative per step, BatchNorm statistics after it atol 5e-3 / rtol
2e-2 at the stem (the deep stages hold 16 samples per channel and are
hypersensitive to the allowed drift).
"""
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from medicalseg_tpu.core import state as jstate
from medicalseg_tpu.models import VNet as JVNet
from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.utils import loss_utils as jlu
from medicalseg_torch.core.state import (TrainState, make_eval_step,
                                         make_train_step)
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.cvlibs.config import Config
from medicalseg_torch.models import VNet
from medicalseg_torch.models import losses as tlosses
from medicalseg_torch.utils import loss_utils as tlu
from medicalseg_torch.utils import transplant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUNG = os.path.join(ROOT, "configs", "lung_coronavirus",
                    "vnet_lung_coronavirus_128_128_128_15k_tpu.yml")
LR, END_LR, POWER, DECAY_STEPS = 0.01, 0.0, 0.9, 20
MOMENTUM, WEIGHT_DECAY = 0.9, 1e-4
N_CLASSES = 2
SHAPE = (2, 16, 16, 16)
# The upstream spine recipe's kernels and strides (configs/mri_spine_seg/
# vnet_mri_spine_seg_512_512_12_15k_tpu.yml: VALID down convs, W 12 -> 9 ->
# 8 -> 4 -> 2) at a small D and H. The port's step runs in bf16 as that
# config does and is held to the JAX package's step in f32, each leaf
# within chip_smoke.py's bf16 bound, 0.35 relative L2 (a conv bias that
# feeds a BatchNorm relative to its conv's weight gradient). Measured: the
# port's bf16 step 0.16 (median leaf) and 0.29 (worst) from the JAX f32
# step; the JAX bf16 step on the CPU itself sits 0.51 (median) from it.
SPINE_KS = ((2, 2, 4), (2, 2, 2), (2, 2, 2), (2, 2, 2))
SPINE_SS = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2))
SPINE_SHAPE = (2, 32, 32, 12)
SPINE_GRAD_REL_L2 = 0.35


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.RandomState(7)
    return (rng.rand(*SHAPE, 1).astype(np.float32),
            rng.randint(0, N_CLASSES, SHAPE).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_trajectory(steps=5):
    """The JAX trainer's start state and what it logs over ``steps`` steps
    of one repeated batch: one jitted step shared by the module."""
    images, labels = _batch()
    model = JVNet(in_channels=1, num_classes=N_CLASSES, dropout=False)
    tx = optax.chain(
        optax.add_decayed_weights(WEIGHT_DECAY),
        optax.sgd(optax.polynomial_schedule(LR, END_LR, POWER, DECAY_STEPS),
                  momentum=MOMENTUM))
    state = jstate.TrainState.create(model, tx, jnp.asarray(images),
                                     jax.random.PRNGKey(3))
    start = jax.device_get(state.variables)
    losses = {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}
    step = jax.jit(jstate.make_train_step(losses))
    key = jax.random.PRNGKey(0)
    log = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(images),
                              jnp.asarray(labels), key)
        trace = [s.trace for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda s: hasattr(s, "trace"))
            if hasattr(s, "trace")][0]
        log.append({"metrics": jax.device_get(metrics),
                    "trace": jax.device_get(trace),
                    "variables": jax.device_get(state.variables)})
    return start, log


def _port_state(start, remat=False, dropout=False, seed=0):
    model = VNet(num_classes=N_CLASSES, dropout=dropout, remat=remat)
    model.load_state_dict(transplant.state_dict_from_flax(start))
    return TrainState.create(
        model,
        lambda p: torch.optim.SGD(p, lr=LR, momentum=MOMENTUM,
                                  weight_decay=WEIGHT_DECAY),
        tconfig.polynomial_decay(LR, DECAY_STEPS, END_LR, POWER), seed=seed,
        device="cpu")


def _port_losses():
    return {"types": [tlosses.MixedLoss(
        [tlosses.CrossEntropyLoss(), tlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def test_iteration_0_loss_and_gradients_match_jax_at_every_leaf():
    start, log = _jax_trajectory()
    images, labels = _batch()
    state = _port_state(start)
    state, metrics = make_train_step(_port_losses())(state, images, labels)
    ref = log[0]["metrics"]
    np.testing.assert_allclose(metrics["loss"].item(), float(ref["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(metrics["loss_list"].numpy(),
                               np.asarray(ref["loss_list"]), rtol=2e-4)
    np.testing.assert_allclose(metrics["per_channel_dice"].numpy(),
                               np.asarray(ref["per_channel_dice"]),
                               rtol=2e-4)
    # after one step the optax trace is g + wd * p0: the JAX step's own
    # gradient is the trace less the decay term
    jgrads = jax.tree_util.tree_map(lambda t, p: t - WEIGHT_DECAY * p,
                                    log[0]["trace"], start["params"])
    ours = _leaves(transplant.grads_to_flax(state.model))
    theirs = _leaves(jgrads)
    assert [k for k, _ in ours] == [k for k, _ in theirs] and len(ours) > 100
    for (name, a), (_, b) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=5e-3,
                                   err_msg=name)
    # and the momentum buffers are the trace itself
    moved = _leaves(transplant.momentum_to_flax(state.model,
                                                state.optimizer))
    for (name, a), (_, b) in zip(moved, _leaves(log[0]["trace"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=5e-3,
                                   err_msg=name)


def test_five_step_trajectory_and_batchnorm_statistics_match_jax():
    start, log = _jax_trajectory()
    images, labels = _batch()
    state = _port_state(start)
    step = make_train_step(_port_losses())
    ours = []
    for _ in range(5):
        state, metrics = step(state, images, labels)
        ours.append(metrics["loss"].item())
    theirs = [float(entry["metrics"]["loss"]) for entry in log]
    np.testing.assert_allclose(ours, theirs, rtol=1e-3)
    assert ours[-1] < ours[0] and state.step == 5
    # Free-running statistics at the stem (8192 samples per channel). At
    # 16^3 the deepest stage is 1^3: its BatchNorm sees two samples per
    # channel, so its backward amplifies rounding noise by 1 / sigma and
    # the two trainers' weights drift apart from step 1 on (measured: the
    # stem's running mean by 1.1e-2 after five steps, its variance by
    # 1.1e-3). test_port_step_from_the_jax_trainer_state holds every
    # statistic of every step tightly, without the drift.
    moved = transplant.flax_from_state_dict(state.model.state_dict())
    ref = log[-1]["variables"]
    for stat in ("mean", "var"):
        np.testing.assert_allclose(
            moved["batch_stats"]["InputTransition_0"]["BatchNorm3D_0"][stat],
            ref["batch_stats"]["InputTransition_0"]["BatchNorm3D_0"][stat],
            atol=2e-2, rtol=2e-2)


def test_spine_recipe_bf16_step_gradients_match_jax():
    """One train step of the spine recipe's VNet in bf16 (batch statistics,
    no dropout, MixedLoss(CE + Dice)) against the JAX package's step in
    f32 from the same weights: the loss within 1e-2, every leaf's gradient
    within its relative-L2 bound."""
    rng = np.random.RandomState(11)
    images = rng.rand(*SPINE_SHAPE, 1).astype(np.float32)
    labels = rng.randint(0, N_CLASSES, SPINE_SHAPE).astype(np.int32)
    jmodel = JVNet(in_channels=1, num_classes=N_CLASSES, dropout=False,
                   kernel_size=SPINE_KS, stride_size=SPINE_SS,
                   head_conv="pallas", mid_conv="pallas")
    variables = jax.device_get(jax.jit(
        lambda k, a: jmodel.init(k, a, train=False))(
            jax.random.PRNGKey(5), jnp.asarray(images)))
    jl = {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}

    def loss_fn(params):
        outs, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        loss_list, _ = jlu.loss_computation(outs, jnp.asarray(labels), jl)
        return sum(loss_list)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    port = VNet(num_classes=N_CLASSES, dropout=False, kernel_size=SPINE_KS,
                stride_size=SPINE_SS, dtype=torch.bfloat16)
    port.load_state_dict(transplant.state_dict_from_flax(variables))
    outs = port.train()(torch.from_numpy(images))
    loss_list, _ = tlu.loss_computation(outs, torch.from_numpy(labels).long(),
                                        _port_losses())
    loss = sum(loss_list)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    # the JAX gradients in the port's names and layouts
    want = transplant.state_dict_from_flax(
        {"params": jax.device_get(jgrads),
         "batch_stats": variables["batch_stats"]})
    grads = dict(port.named_parameters())
    assert len(grads) > 100
    for name, p in grads.items():
        ref = want[name].float()
        scale = ref.norm()
        if name.endswith(("conv1.bias", "down_conv.bias", "up_conv.bias")):
            scale = want[name[:-4] + "weight"].float().norm()
        rel = ((p.grad.float() - ref).norm() / scale.clamp_min(1e-30)).item()
        assert rel <= SPINE_GRAD_REL_L2, (name, rel)


@pytest.mark.parametrize("done", [1, 2, 3, 4])
def test_port_step_from_the_jax_trainer_state(done):
    """Start the port from the JAX trainer's state after ``done`` steps
    (weights, statistics, momentum trace, step count) and take one step:
    its loss is the JAX trainer's next loss, and every BatchNorm statistic
    of the net is the JAX trainer's next one (atol 5e-3 / rtol 2e-2, the
    oracle test's bound for the stem, here at every layer)."""
    _, log = _jax_trajectory()
    images, labels = _batch()
    state = _port_state(log[done - 1]["variables"])
    transplant.momentum_from_flax(state.model, state.optimizer,
                                  log[done - 1]["trace"])
    state.step = done
    assert state.lr == pytest.approx(
        LR * (1 - done / DECAY_STEPS) ** POWER)
    state, metrics = make_train_step(_port_losses())(state, images, labels)
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(log[done]["metrics"]["loss"]),
                               rtol=2e-4)
    moved = transplant.flax_from_state_dict(state.model.state_dict())
    ours = _leaves(moved["batch_stats"])
    theirs = _leaves(log[done]["variables"]["batch_stats"])
    assert len(ours) == len(theirs) == 2 * 24
    for (name, a), (_, b) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-3, rtol=2e-2,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["remat", "full"])
def test_remat_changes_no_gradient_and_updates_statistics_once(mode):
    """Per-block (the model's ``remat`` key) and whole-forward
    (``checkpoint_policy='full'``) rematerialization, dropout ON: the
    recomputed forward reuses the dropout masks and leaves the BatchNorm
    statistics alone, so gradients and statistics equal the plain step's
    bit for bit."""
    start, _ = _jax_trajectory()
    images, labels = _batch()
    plain = _port_state(start, dropout=True, seed=5)
    other = _port_state(start, remat=(mode == "remat"), dropout=True, seed=5)
    make_train_step(_port_losses())(plain, images, labels)
    make_train_step(_port_losses(), checkpoint_policy=(
        "full" if mode == "full" else None))(other, images, labels)
    for (name, a), (_, b) in zip(plain.model.named_parameters(),
                                 other.model.named_parameters()):
        assert a.grad is not None and a.grad.abs().sum() > 0, name
        assert torch.equal(a.grad, b.grad), name
    for (name, a), (_, b) in zip(plain.model.named_buffers(),
                                 other.model.named_buffers()):
        assert torch.equal(a, b), name
    m = 0.9
    bn = other.model.in_tr.bn1
    assert not torch.equal(bn.running_mean, torch.zeros(16))
    # one update: var = m * 1 + (1 - m) * batch_var  =>  batch_var >= 0
    assert ((bn.running_var - m) / (1 - m) >= 0).all()


def test_wire_dtypes_widen_on_the_device_and_metrics_stay_there():
    start, _ = _jax_trajectory()
    images, labels = _batch()
    a, b = _port_state(start), _port_state(start)
    step = make_train_step(_port_losses())
    _, ma = step(a, images, labels)
    _, mb = step(b, torch.from_numpy(images).bfloat16().float().half(),
                 torch.from_numpy(labels).to(torch.uint8))
    assert mb["loss"].dtype == torch.float32 and not mb["loss"].requires_grad
    assert mb["loss_list"].shape == (2,)
    assert mb["per_channel_dice"].shape == (N_CLASSES,)
    np.testing.assert_allclose(ma["loss"].item(), mb["loss"].item(),
                               rtol=5e-3)
    with pytest.raises(ValueError, match="checkpoint_policy"):
        make_train_step(_port_losses(), checkpoint_policy="half")


def test_augment_fn_is_called_with_the_state_generator():
    start, _ = _jax_trajectory()
    images, labels = _batch()
    state = _port_state(start)
    seen = {}

    def flip(im, lab, generator):
        seen["generator"] = generator
        seen["dtypes"] = (im.dtype, lab.dtype)
        return im.flip(1), lab.flip(1)

    _, m_aug = make_train_step(_port_losses(), augment_fn=flip)(
        state, images, labels)
    assert seen["generator"] is state.generator
    assert seen["dtypes"] == (torch.float32, torch.int64)
    _, m_ref = make_train_step(_port_losses())(
        _port_state(start), images[:, ::-1].copy(), labels[:, ::-1].copy())
    assert m_aug["loss"].item() == m_ref["loss"].item()


def test_eval_step_matches_jax_eval_step():
    start, _ = _jax_trajectory()
    images, labels = _batch()
    jmodel = JVNet(in_channels=1, num_classes=N_CLASSES, dropout=False)
    jst = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=start["params"],
        batch_stats=start["batch_stats"], opt_state=None,
        apply_fn=jmodel.apply, tx=None)
    jl = {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}
    rlogits, rll, rpcd = jstate.make_eval_step(jl)(
        jst, jnp.asarray(images), jnp.asarray(labels))
    state = _port_state(start)
    logits, ll, pcd = make_eval_step(_port_losses())(state, images, labels)
    assert not state.model.training and not logits[0].requires_grad
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(rlogits[0]),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose([l.item() for l in ll],
                               [float(l) for l in rll], rtol=2e-4)
    np.testing.assert_allclose(pcd.numpy(), np.asarray(rpcd), rtol=2e-4)


OPTIMIZERS = {
    "sgd": ({"type": "sgd", "momentum": 0.9, "weight_decay": 1e-2},
            lambda lr: optax.chain(optax.add_decayed_weights(1e-2),
                                   optax.sgd(lr, momentum=0.9))),
    "nesterov": ({"type": "momentum", "momentum": 0.8, "use_nesterov": True},
                 lambda lr: optax.sgd(lr, momentum=0.8, nesterov=True)),
    "adam": ({"type": "adam", "weight_decay": 1e-2},
             lambda lr: optax.chain(optax.add_decayed_weights(1e-2),
                                    optax.adam(lr))),
    "adamw": ({"type": "adamw", "weight_decay": 1e-2},
              lambda lr: optax.adamw(lr, weight_decay=1e-2)),
    "rmsprop": ({"type": "rmsprop", "momentum": 0.5, "weight_decay": 1e-2},
                lambda lr: optax.chain(
                    optax.add_decayed_weights(1e-2),
                    optax.rmsprop(lr, decay=0.95, eps=1e-6, momentum=0.5))),
}


def _write_config(tmp_path, **sections):
    import yaml
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.dump({"iters": 20, **sections}))
    return Config(str(path))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_and_poly_schedule_match_optax_for_20_steps(tmp_path,
                                                              name):
    """The config's optimizer block and PolynomialDecay on a toy parameter
    with a fixed sequence of gradients: the same 20 updates as optax
    (float32 on both sides; atol 1e-5 for 20 rounded updates of O(1)
    entries)."""
    block, make_tx = OPTIMIZERS[name]
    cfg = _write_config(tmp_path, optimizer=block, lr_scheduler={
        "type": "PolynomialDecay", "learning_rate": 0.1, "end_lr": 0.01,
        "power": 0.9})
    rng = np.random.RandomState(0)
    p0 = rng.randn(7).astype(np.float32)
    grads = rng.randn(20, 7).astype(np.float32)
    tx = make_tx(optax.polynomial_schedule(0.1, 0.01, 0.9, 20))
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, schedule = cfg.build_optimizer([tp]), cfg.lr_scheduler
    for i in range(20):
        upd, opt_state = tx.update(jnp.asarray(grads[i]), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        tp.grad = torch.from_numpy(grads[i].copy())
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("block,ref", [
    ({"type": "PolynomialDecay", "learning_rate": 1e-3, "end_lr": 0,
      "power": 0.9, "decay_steps": 15000},
     optax.polynomial_schedule(1e-3, 0.0, 0.9, 15000)),
    ({"type": "PolynomialDecay", "learning_rate": 0.1},
     optax.polynomial_schedule(0.1, 0.0, 0.9, 20)),
    ({"type": "CosineAnnealingDecay", "learning_rate": 0.1, "eta_min": 0.01},
     optax.cosine_decay_schedule(0.1, 20, alpha=0.1)),
    ({"type": "StepDecay", "learning_rate": 0.1, "step_size": 6,
      "gamma": 0.5}, lambda s: 0.1 * 0.5 ** (s // 6)),
    ({"type": "PiecewiseDecay", "boundaries": [5, 11],
      "values": [0.1, 0.01, 0.001]},
     lambda s: [0.1, 0.01, 0.001][(s >= 5) + (s >= 11)]),
], ids=["poly-lung", "poly-defaults", "cosine", "step", "piecewise"])
def test_schedules_match_optax(tmp_path, block, ref):
    schedule = _write_config(tmp_path, lr_scheduler=block).lr_scheduler
    # optax evaluates in float32: 1 - 14999 / 15000 keeps three digits
    for step in (0, 1, 5, 6, 11, 19, 20, 25, 14999, 20000):
        np.testing.assert_allclose(schedule(step), float(ref(step)),
                                   rtol=1e-5, atol=1e-9, err_msg=str(step))


def test_legacy_learning_rate_block_and_errors(tmp_path):
    cfg = _write_config(tmp_path, learning_rate={
        "value": 0.05, "decay": {"type": "poly", "end_lr": 0.0,
                                 "power": 0.9}},
        optimizer={"type": "sgd"})
    ref = optax.polynomial_schedule(0.05, 0.0, 0.9, 20)
    for step in (0, 3, 20):
        np.testing.assert_allclose(cfg.learning_rate(step), float(ref(step)),
                                   rtol=1e-5, atol=1e-12)
    opt = cfg.build_optimizer([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.SGD)
    assert opt.defaults["momentum"] == 0.9 and opt.defaults["lr"] == 0.05
    with pytest.raises(RuntimeError, match="lr_scheduler"):
        cfg.lr_scheduler
    bad = _write_config(tmp_path, optimizer={"type": "lion"},
                        lr_scheduler={"type": "Linear", "learning_rate": 1})
    with pytest.raises(RuntimeError, match="Unknown lr_scheduler"):
        bad.lr_scheduler
    no_iters = _write_config(tmp_path)
    del no_iters.dic["iters"]
    with pytest.raises(RuntimeError, match="iters"):
        no_iters.iters
    over = Config(LUNG, learning_rate=0.5, batch_size=3, iters=10)
    assert over.batch_size == 3 and over.iters == 10
    assert over.lr_scheduler(0) == 0.5


def test_config_builds_the_lung_recipe():
    cfg = Config(LUNG)
    assert cfg.batch_size == 6 and cfg.iters == 15000
    assert cfg.dic["model"]["remat"] is True
    schedule = cfg.lr_scheduler
    ref = optax.polynomial_schedule(1e-3, 0.0, 0.9, 15000)
    for step in (0, 100, 7500, 15000):
        np.testing.assert_allclose(schedule(step), float(ref(step)),
                                   rtol=1e-5, atol=1e-12)
    opt = cfg.build_optimizer([torch.nn.Parameter(torch.zeros(3))])
    assert isinstance(opt, torch.optim.SGD)
    d = opt.defaults
    assert (d["momentum"], d["weight_decay"], d["nesterov"], d["lr"]) == (
        0.9, 1e-4, False, 1e-3)
    loss = cfg.loss
    assert loss["coef"] == [1] and len(loss["types"]) == 1
    mixed = loss["types"][0]
    assert isinstance(mixed, tlosses.MixedLoss) and mixed.coef == [1, 1]
    ce, dice = mixed.losses
    assert isinstance(ce, tlosses.CrossEntropyLoss) and ce.weight is None
    assert isinstance(dice, tlosses.DiceLoss) and dice.sigmoid_norm
    assert ce.ignore_index == dice.ignore_index == 255
    assert cfg.loss is loss


def test_loss_config_broadcasts_types_and_checks_lengths(tmp_path):
    cfg = _write_config(tmp_path, loss={
        "types": [{"type": "DiceLoss"}], "coef": [1, 0.5, 0.25]})
    assert len(cfg.loss["types"]) == 3
    with pytest.raises(ValueError, match="length of types"):
        _write_config(tmp_path, loss={
            "types": [{"type": "DiceLoss"}] * 2, "coef": [1, 1, 1]}).loss
    with pytest.raises(ValueError, match="types"):
        _write_config(tmp_path, loss={"coef": [1]}).loss
    with pytest.raises(ValueError, match="ignore_index"):
        _write_config(tmp_path, loss={"types": [
            {"type": "DiceLoss", "ignore_index": 0}], "coef": [1]}).loss


def test_model_remat_key_reaches_the_port_model():
    model = tconfig.build_model({"type": "VNet", "num_classes": 2,
                                 "remat": True, "head_conv": "pallas",
                                 "dtype": "bfloat16"})
    assert model.remat is True and model.dtype == torch.bfloat16
    assert tconfig.build_model({"type": "VNet",
                                "num_classes": 2}).remat is False


def test_dropout_masks_come_from_the_state_generator():
    state = TrainState.create(
        VNet(num_classes=2), lambda p: torch.optim.SGD(p, lr=0.1),
        lambda s: 0.1, seed=11, device="cpu")
    drops = [m for m in state.model.modules()
             if type(m).__name__ == "ChannelDropout"]
    assert len(drops) == 6
    assert all(m.generator is state.generator for m in drops)
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: nothing to check")
        TrainState.create(VNet(num_classes=2),
                          lambda p: torch.optim.SGD(p, lr=0.1),
                          lambda s: 0.1)  # the default device is the card


def test_gradient_and_momentum_trees_round_trip():
    model = VNet(num_classes=2)
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    tree = transplant.grads_to_flax(model)
    saved = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    transplant.grads_from_flax(model, tree)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, saved[n]), n
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    zeros = transplant.momentum_to_flax(model, opt)
    assert all(not leaf.any() for _, leaf in _leaves(zeros))
    transplant.momentum_from_flax(model, opt, tree)
    back = transplant.momentum_to_flax(model, opt)
    for (n, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(a, b, err_msg=n)
    # flax kernel layouts: conv [kd, kh, kw, Ci, Co], flipped deconv
    assert tree["InputTransition_0"]["Conv_0"]["kernel"].shape == (
        5, 5, 5, 1, 16)
    up = tree["UpTransition_3"]["ConvTranspose_0"]["kernel"]
    want = saved["up_tr32.up_conv.weight"].permute(2, 3, 4, 0, 1).flip(
        0, 1, 2)
    np.testing.assert_array_equal(up, want.numpy())
