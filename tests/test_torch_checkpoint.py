"""The port's checkpoints (medicalseg_torch.utils.checkpoint and its
msgpack codec) against the JAX package's on the CPU: a checkpoint written
by either package loads into the other, and the SGD momentum the port
writes is optax's trace after the same updates.

V-Net with 2 classes (its widths are fixed, so the tree is full size; the
train steps run at 16^3). Variables and statistics are compared exactly
(float32 values round-trip through msgpack unchanged); the momentum
against optax's trace at rtol 1e-5 (the same float32 operations, fused
differently). No JAX train step is compiled: the JAX VNet's variables are
traced to shapes, and optax's update runs eagerly on the port's gradients.
"""
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from medicalseg_tpu.models import VNet as JVNet
from medicalseg_tpu.utils import checkpoint as jckpt
from medicalseg_torch.core.state import TrainState, make_train_step
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.models import VNet
from medicalseg_torch.models import losses as tlosses
from medicalseg_torch.utils import checkpoint as tckpt
from medicalseg_torch.utils import transplant
from medicalseg_torch.utils.msgpack_codec import packb, unpackb

LR, MOMENTUM, WEIGHT_DECAY, DECAY_STEPS = 0.01, 0.9, 1e-4, 20


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


@functools.lru_cache(maxsize=None)
def _jax_template():
    """The JAX VNet's variables as shapes (traced, not compiled)."""
    jmodel = JVNet(in_channels=1, num_classes=2, dropout=False)
    return jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)), train=False))


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def _sgd(params):
    return torch.optim.SGD(params, lr=LR, momentum=MOMENTUM,
                           weight_decay=WEIGHT_DECAY)


def _tx():
    return optax.chain(
        optax.add_decayed_weights(WEIGHT_DECAY),
        optax.sgd(optax.polynomial_schedule(LR, 0.0, 0.9, DECAY_STEPS),
                  momentum=MOMENTUM))


def test_msgpack_codec_reads_and_writes_flax_bytes():
    rng = np.random.RandomState(0)
    tree = {"params": {"a": rng.rand(3, 4).astype(np.float32),
                       "b": {"c": np.arange(70, dtype=np.int32)}},
            "step": np.asarray(12), "empty": {}}
    ours = unpackb(serialization.to_bytes(tree))
    back = serialization.msgpack_restore(packb(tree))
    for got in (ours, back):
        np.testing.assert_array_equal(got["params"]["a"],
                                      tree["params"]["a"])
        np.testing.assert_array_equal(got["params"]["b"]["c"],
                                      tree["params"]["b"]["c"])
        assert int(got["step"]) == 12 and got["empty"] == {}
    plain = {"s": "x" * 300, "n": [-1, 2 ** 40, -2 ** 40, 1.5, None, True],
             "raw": b"\x00" * 70000}
    assert unpackb(packb(plain)) == plain
    with pytest.raises(ValueError, match="truncated"):
        unpackb(packb(plain)[:-5])


def test_port_checkpoint_loads_into_the_jax_package(tmp_path, model):
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for i, buf in enumerate(model.buffers()):
            buf.add_(0.01 * (i + 1))
    try:
        tckpt.save_checkpoint(str(tmp_path / "iter_3"), model,
                              _sgd(model.parameters()), 3)
        want = transplant.flax_from_state_dict(model.state_dict())
    finally:
        model.load_state_dict(saved)
    assert sorted(os.listdir(tmp_path / "iter_3")) == ["model.msgpack",
                                                       "opt.msgpack"]
    template = _jax_template()
    variables, _, _ = jckpt.load_checkpoint(str(tmp_path / "iter_3"),
                                            template)
    ours, theirs = _leaves(variables), _leaves(want)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    assert [k for k, _ in ours] == [k for k, _ in _leaves(template)]
    for (name, a), (_, b), (_, s) in zip(ours, theirs, _leaves(template)):
        assert a.shape == s.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_jax_checkpoint_loads_into_the_port(tmp_path, model):
    """The JAX package's ``save_checkpoint`` of variables and an optax
    state shaped like the JAX VNet's (values moved off the port model's,
    so that every leaf changes) loads into the port by ``resume``."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    base = transplant.flax_from_state_dict(saved)
    variables = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, base)
    trace = jax.tree_util.tree_map(lambda a: a - 0.25, variables["params"])
    opt_state = (optax.EmptyState(),
                 (optax.TraceState(trace=trace),
                  optax.ScaleByScheduleState(count=jnp.asarray(5))))
    jckpt.save_checkpoint(str(tmp_path / "iter_5"), variables, opt_state, 5)

    optimizer = _sgd(model.parameters())
    try:
        assert tckpt.resume(model, optimizer, str(tmp_path / "iter_5")) == 5
        moved = transplant.flax_from_state_dict(model.state_dict())
        momentum = transplant.momentum_to_flax(model, optimizer)
    finally:
        model.load_state_dict(saved)
    pairs = list(zip(_leaves(moved), _leaves(variables)))
    assert len(pairs) == len(_leaves(_jax_template())) > 100
    for (name, a), (_, b) in pairs:
        np.testing.assert_array_equal(a, b, err_msg=name)
    for (name, a), (_, b) in zip(_leaves(momentum), _leaves(trace)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_sgd_trace_matches_optax_after_the_same_updates(tmp_path, model):
    """Two port steps; optax's update applied to the same gradients and
    parameters gives the trace the port's ``opt.msgpack`` holds, as the
    JAX package's ``load_checkpoint`` reads it."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(7)
    images = rng.rand(2, 16, 16, 16, 1).astype(np.float32)
    labels = rng.randint(0, 2, (2, 16, 16, 16)).astype(np.int32)
    state = TrainState.create(
        model, _sgd, tconfig.polynomial_decay(LR, DECAY_STEPS, 0.0, 0.9),
        device="cpu")
    step = make_train_step({"types": [tlosses.MixedLoss(
        [tlosses.CrossEntropyLoss(), tlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]})
    tx = _tx()
    params = transplant.flax_from_state_dict(model.state_dict())["params"]
    opt_state = tx.init(params)
    try:
        for _ in range(2):
            params = transplant.flax_from_state_dict(
                model.state_dict())["params"]
            state, _ = step(state, images, labels)
            _, opt_state = tx.update(transplant.grads_to_flax(model),
                                     opt_state, params)
        tckpt.save_checkpoint(str(tmp_path / "iter_2"), model,
                              state.optimizer, state.step)
    finally:
        model.load_state_dict(saved)
        model.zero_grad(set_to_none=True)
    _, loaded, step_n = jckpt.load_checkpoint(
        str(tmp_path / "iter_2"), _jax_template(), tx.init(params))
    assert step_n == 2 and int(loaded[1][1].count) == 2
    ours = _leaves(loaded[1][0].trace)
    theirs = _leaves(opt_state[1][0].trace)
    assert len(ours) == len(theirs) > 100
    for (name, a), (_, b) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-8,
                                   err_msg=name)


def test_other_optimizers_keep_their_own_state(tmp_path, model):
    """Adam's state goes to ``opt.msgpack`` as ``opt_state['torch']``,
    which only the port reads back."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    try:
        opt.step()
        tckpt.save_checkpoint(str(tmp_path / "iter_1"), model, opt, 1)
        fresh = torch.optim.Adam(model.parameters(), lr=0.1)
        assert tckpt.load_checkpoint(str(tmp_path / "iter_1"), model,
                                     fresh) == 1
    finally:
        model.load_state_dict(saved)
        model.zero_grad(set_to_none=True)
    with open(tmp_path / "iter_1" / "opt.msgpack", "rb") as f:
        assert set(unpackb(f.read())["opt_state"]) == {"torch"}
    for a, b in zip(fresh.state_dict()["state"].values(),
                    opt.state_dict()["state"].values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])


def test_pretrained_loading_skips_what_does_not_fit(tmp_path, model):
    """``load_pretrained_model`` takes every entry of the file that matches
    the model's by name and shape, and skips (warning) the others."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    variables = transplant.flax_from_state_dict(saved)
    variables = jax.tree_util.tree_map(lambda a: a + 1.0, variables)
    head = variables["params"]["OutputTransition_0"]["Conv_0"]
    head["kernel"] = np.zeros((1, 1, 1, 32, 7), np.float32)  # 7 classes
    path = tmp_path / "model.msgpack"
    path.write_bytes(packb(variables))
    try:
        n = tckpt.load_pretrained_model(model, str(tmp_path))
        got = model.state_dict()
        assert n == len(saved) - 1
        assert torch.equal(got["out_tr.conv2.weight"],
                           saved["out_tr.conv2.weight"])
        assert torch.equal(got["in_tr.conv1.weight"],
                           saved["in_tr.conv1.weight"] + 1.0)
    finally:
        model.load_state_dict(saved)
