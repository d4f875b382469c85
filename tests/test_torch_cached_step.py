"""The port's cached and multi-step training on the CPU, against the JAX
package: ``core.state.make_cached_train_step`` and ``make_multi_step``
against the JAX functions of the same names, the ``device_cache`` loader
mode (``auto``'s choice, the index vectors, ``build_device_cache``)
against the JAX loader on the same files, ``core.train`` with
``steps_per_dispatch`` 2 against single steps and ``device_cache`` against
``device`` mode (the torch encoder-decoder below on three 16^3 volumes with
a random flip), the optimizers' capturable forms against the optax chains
and the eager forms, and ``utils.train_profiler`` against the JAX module's
parsing.

The steps' comparison runs the flax/torch pair of small encoder-decoders
of tests/test_torch_trajectory.py (float32, batch 2 at 16^3, no dropout,
MixedLoss(CE + Dice), SGD with momentum and weight decay, a poly LR):
each step's loss within 2e-4 relative and the final parameters within
5e-4 relative L2 a leaf, the tolerances of that file (the JAX package's
CPU cross-entropy is 4e-5 from the exact value). Within the port the
cached and multi-step forms hold to the eager step to 1e-5: the same
float32 operations, but the eager step takes its batches from numpy in
other strides, which the CPU convolution sums in another order (on
batches gathered as the cached step gathers them, they agree bit for
bit).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from medicalseg_tpu.core import loader as jloader
from medicalseg_tpu.core import state as jstate
from medicalseg_tpu.datasets import MedicalDataset as JMedicalDataset
from medicalseg_tpu.transforms import RandomFlip3D as JRandomFlip3D
from medicalseg_tpu.transforms import \
    BinaryMaskToConnectComponent as JBinaryMask
from medicalseg_tpu.utils import train_profiler as jprofiler
from medicalseg_torch.core import loader as tloader
from medicalseg_torch.core.state import (make_cached_train_step,
                                         make_multi_step, make_train_step)
from medicalseg_torch.core.train import train
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.datasets import MedicalDataset
from medicalseg_torch.models import losses as tlosses
from medicalseg_torch.transforms import (BinaryMaskToConnectComponent,
                                         RandomFlip3D)
from medicalseg_torch.utils import train_profiler
from tests.test_torch_train import OPTIMIZERS, _write_config
from tests.test_torch_trajectory import (BATCH, EDGE, JaxMiniSegNet, NOISE,
                                         TOL_LOSS, TOL_PARAM,
                                         TorchMiniSegNet, bank,
                                         flax_leaves, index_stream,
                                         jax_losses, port_losses,
                                         port_state, _rel_l2)

STEPS = 6
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the steps against the JAX package's
# --------------------------------------------------------------------------
def _jax_start():
    tx = optax.chain(
        optax.add_decayed_weights(1e-4),
        optax.sgd(optax.polynomial_schedule(LR, 0.0, 0.9, 40),
                  momentum=0.9))
    return jstate.TrainState.create(
        JaxMiniSegNet(), tx, jnp.zeros((BATCH, EDGE, EDGE, EDGE, 1)),
        jax.random.PRNGKey(3))


@pytest.mark.parametrize("form,n", [("cached", 1), ("cached", 3),
                                    ("multi", 3)])
def test_cached_and_multi_steps_match_the_jax_functions(form, n):
    """``STEPS`` updates, ``n`` a call, through the JAX function and the
    port's of the same name, from the same weights and batches."""
    images, labels = bank()
    stream = index_stream(STEPS)
    cache = images[..., None], labels
    state = _jax_start()
    start = jax.device_get(state.variables)
    key = jax.random.PRNGKey(0)
    if form == "cached":
        jstep = jax.jit(jstate.make_cached_train_step(jax_losses(), n))
        tstep = make_cached_train_step(port_losses(), n)
    else:
        jstep = jax.jit(jstate.make_multi_step(jax_losses(), n))
        tstep = make_multi_step(port_losses(), n)
    ours = port_state(start)
    tcache = tuple(torch.from_numpy(a) for a in cache)
    jlosses_, tlosses_ = [], []
    rows = stream.reshape(-1, n, BATCH) if n > 1 else stream
    for idx in rows:
        if form == "cached":
            state, jm = jstep(state, *map(jnp.asarray, cache),
                              jnp.asarray(idx), key)
            _, tm = tstep(ours, *tcache, idx)
        else:
            im, lab = cache[0][idx], cache[1][idx]
            state, jm = jstep(state, jnp.asarray(im), jnp.asarray(lab), key)
            _, tm = tstep(ours, torch.from_numpy(im), torch.from_numpy(lab))
        jlosses_.extend(np.atleast_1d(np.asarray(jm["loss"])))
        tlosses_.extend(tm["loss"].reshape(-1).tolist())
        assert tm["per_channel_dice"].shape == jm["per_channel_dice"].shape
        assert tm["loss_list"].shape == jm["loss_list"].shape
    assert ours.step == int(state.step) == STEPS
    np.testing.assert_allclose(tlosses_, jlosses_, rtol=TOL_LOSS)
    ref = flax_leaves(*jax.device_get((state.params, state.batch_stats)))
    got = ours.model.leaves()
    for k in ref:
        if k != NOISE:
            assert _rel_l2(got[k], ref[k]) <= TOL_PARAM, k


def test_multi_and_cached_steps_are_the_eager_steps():
    """Three updates a call through each form against three eager steps:
    the same numbers (1e-5), the metrics stacked along [3], and the step
    counter advanced per update."""
    images, labels = bank()
    stream = index_stream(3)
    start = jax.device_get(_jax_start().variables)
    eager, cached, multi = (port_state(start) for _ in range(3))
    step = make_train_step(port_losses())
    for idx in stream:
        _, em = step(eager, images[idx][..., None], labels[idx])
    cache = torch.from_numpy(images[..., None]), torch.from_numpy(labels)
    _, cm = make_cached_train_step(port_losses(), 3)(cached, *cache, stream)
    _, mm = make_multi_step(port_losses(), 3)(
        multi, torch.from_numpy(images[stream][..., None]),
        torch.from_numpy(labels[stream]))
    for m in (cm, mm):
        assert m["loss"].shape == (3,) and m["per_channel_dice"].shape == (
            3, 3)
        assert abs(m["loss"][-1].item() - em["loss"].item()) <= 1e-5
    for st in (cached, multi):
        assert st.step == 3
        for k, v in eager.model.leaves().items():
            if k != NOISE:
                assert _rel_l2(st.model.leaves()[k], v) <= 1e-5, k
    with pytest.raises(ValueError, match="1 to 3"):
        make_multi_step(port_losses(), 3)(
            multi, torch.zeros((4, 2, 4, 4, 4, 1)), torch.zeros((4, 2, 4, 4,
                                                                 4)))


def test_the_cached_step_reseeds_per_update_from_seed_and_step():
    """With ``seed`` the generator is seeded from (seed, step) before each
    update, as the train loop does: the draws of an augmentation that
    records the generator's seed follow the step counter."""
    from medicalseg_torch.transforms.device import step_seed
    seen = []

    def augment(images, labels, generator):
        seen.append(generator.initial_seed())
        return images, labels

    images, labels = bank()
    start = jax.device_get(_jax_start().variables)
    state = port_state(start)
    state.step = 5
    cache = torch.from_numpy(images[..., None]), torch.from_numpy(labels)
    make_cached_train_step(port_losses(), 2, augment_fn=augment)(
        state, *cache, index_stream(2), seed=7)
    assert seen == [step_seed(7, 5), step_seed(7, 6)] and state.step == 7


# --------------------------------------------------------------------------
# the loader's device_cache mode
# --------------------------------------------------------------------------
def _write(root, shapes, classes=3, seed=0):
    """Seeded volumes of ``shapes`` and their labels as .npy, with train
    and val lists; returns the phase0 directory."""
    phase0 = os.path.join(root, "phase0")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(phase0, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i, shape in enumerate(shapes):
        np.save(os.path.join(phase0, "images", "v{}.npy".format(i)),
                (rng.rand(*shape) * 255).astype(np.float32))
        np.save(os.path.join(phase0, "labels", "v{}.npy".format(i)),
                rng.randint(0, classes, shape).astype(np.uint8))
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    for name in ("train_list.txt", "val_list.txt"):
        with open(os.path.join(phase0, name), "w") as f:
            f.writelines(lines)
    return phase0


CASES = {
    # name: (shapes, host transform, device_cache_bytes)
    "small": ([(8, 12, 12)] * 3, False, 1 << 30),
    "over_the_limit": ([(8, 12, 12)] * 3, False, 3 * 8 * 12 * 12 * 3 - 1),
    "mixed_shapes": ([(8, 12, 12), (8, 12, 16), (8, 12, 12)], False,
                     1 << 30),
    "host_transform": ([(8, 12, 12)] * 3, True, 1 << 30),
}


def _pair(phase0, host, **kw):
    jt = [JBinaryMask()] if host else [JRandomFlip3D()]
    tt = [BinaryMaskToConnectComponent()] if host else [RandomFlip3D()]
    return (JMedicalDataset(phase0, phase0, jt, 3, repeat_train=3, **kw),
            MedicalDataset(phase0, phase0, tt, 3, repeat_train=3, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_picks_the_jax_loaders_mode(tmp_path, case):
    shapes, host, limit = CASES[case]
    phase0 = _write(str(tmp_path), shapes)
    jds, tds = _pair(phase0, host)
    # bfloat16 wire: images 2 bytes a voxel, labels uint8 1: the limit of
    # "over_the_limit" is one byte short of the three volumes
    kw = dict(batch_size=2, num_workers=1, seed=0, wire_dtype="bfloat16",
              device_cache_bytes=limit)
    ref = jloader.TrainLoader(jds, **kw)
    ours = tloader.TrainLoader(tds, **kw)
    try:
        assert ours.mode == ref.mode == {
            "small": "device_cache", "over_the_limit": "device",
            "mixed_shapes": "device", "host_transform": "host"}[case]
        assert ours.unique_pairs == [tuple(p) for p in ref.unique_pairs]
    finally:
        ref.stop()
        ours.stop()


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_device_cache_yields_the_jax_index_vectors_and_cache(tmp_path, wire):
    phase0 = _write(str(tmp_path), [(8, 12, 12)] * 4)
    jds, tds = _pair(phase0, False)
    kw = dict(batch_size=3, num_workers=1, seed=2, mode="device_cache",
              wire_dtype=wire)
    ref = jloader.TrainLoader(jds, **kw)
    ours = tloader.TrainLoader(tds, **kw)
    try:
        for _ in range(9):  # across epoch boundaries (12 items)
            want, got = next(ref), next(ours)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        jimages, jlabels = ref.build_device_cache()
        images, labels = ours.build_device_cache("cpu")
        assert images.shape == jimages.shape == (4, 8, 12, 12)
        assert labels.dtype == {"bfloat16": torch.uint8,
                                "float32": torch.int32}[wire]
        np.testing.assert_array_equal(
            images.float().numpy(), np.asarray(jimages, np.float32))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    finally:
        ref.stop()
        ours.stop()


def test_device_cache_refuses_mixed_shapes_and_host_transforms(tmp_path):
    phase0 = _write(str(tmp_path), [(8, 12, 12), (8, 12, 16)])
    jds, tds = _pair(phase0, False)
    kw = dict(batch_size=1, num_workers=1, mode="device_cache")
    ref = jloader.TrainLoader(jds, **kw)
    ours = tloader.TrainLoader(tds, **kw)
    try:
        with pytest.raises(ValueError, match="uniform volume shapes"):
            ref.build_device_cache()
        with pytest.raises(ValueError, match="uniform volume shapes"):
            ours.build_device_cache("cpu")
    finally:
        ref.stop()
        ours.stop()
    jds, tds = _pair(phase0, True)
    with pytest.raises(ValueError, match="device-supported"):
        jloader.TrainLoader(jds, **kw)
    with pytest.raises(ValueError, match="device-supported"):
        tloader.TrainLoader(tds, **kw)


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cube_data(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("cube")), [(16, 16, 16)] * 3)


@pytest.fixture(autouse=True)
def _torch_checkpoints(monkeypatch):
    """The loop's checkpoints, written in place or asynchronously, as
    ``torch.save`` files: the msgpack layout names V-Net's layers, and
    these tests train the small encoder-decoder
    (tests/test_torch_train_loop.py drives the msgpack checkpoints)."""
    module = __import__("medicalseg_torch.core.train",
                        fromlist=["train"])

    def save(save_dir, model, optimizer=None, step=None):
        os.makedirs(save_dir, exist_ok=True)
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.state_dict(), "step": step},
                   os.path.join(save_dir, "state.pt"))

    def resume(model, optimizer, resume_model):
        if resume_model is None:
            return 0
        saved = torch.load(os.path.join(resume_model, "state.pt"))
        model.load_state_dict(saved["model"])
        optimizer.load_state_dict(saved["optimizer"])
        return saved["step"]

    monkeypatch.setattr(module, "save_checkpoint", save)
    monkeypatch.setattr(module, "save_checkpoint_async", save)
    monkeypatch.setattr(module, "resume", resume)


def _run(phase0, save_dir, iters=4, **kw):
    ds = MedicalDataset(phase0, phase0, [RandomFlip3D()], 3, repeat_train=2)
    torch.manual_seed(0)
    model = TorchMiniSegNet()
    losses = {"types": [tlosses.MixedLoss(
        [tlosses.CrossEntropyLoss(), tlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}
    args = dict(save_interval=iters, log_iters=2)
    args.update(kw)
    return train(model, ds,
                 optimizer=lambda p: torch.optim.SGD(
                     p, lr=0.01, momentum=0.9, weight_decay=1e-4),
                 lr_scheduler=tconfig.polynomial_decay(0.01, iters),
                 save_dir=save_dir, iters=iters, batch_size=1,
                 losses=losses, seed=0, wire_dtype="float32", device="cpu",
                 **args)


def _params(state):
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def _close(a, b, rtol, atol):
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_steps_per_dispatch_2_is_single_steps(tmp_path, cube_data):
    """Two steps a dispatch through ``train`` against one (the same seeds,
    draws and masks, so the same updates): the eager single step's
    optimizer holds its learning rate as a float and the dispatched form's
    as a tensor, so the last bits may differ (rtol 1e-5, atol 1e-6, the
    JAX test's); ``device_cache`` with one step a dispatch against two
    holds bit for bit."""
    single = _run(cube_data, str(tmp_path / "a"),
                  data_loader_mode="device")
    double = _run(cube_data, str(tmp_path / "b"),
                  data_loader_mode="device", steps_per_dispatch=2)
    assert single.step == double.step == 4
    assert type(double.optimizer) is tconfig.SGD
    _close(_params(double), _params(single), 1e-5, 1e-6)
    cached1 = _run(cube_data, str(tmp_path / "c"))
    cached2 = _run(cube_data, str(tmp_path / "d"), steps_per_dispatch=2)
    for a, b in zip(_params(cached1).values(), _params(cached2).values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="must divide"):
        _run(cube_data, str(tmp_path / "e"), steps_per_dispatch=3)


def test_device_cache_mode_is_device_mode(tmp_path, cube_data):
    """``auto`` picks ``device_cache`` for the three 16^3 volumes, and its
    run takes the batches, draws and masks of a ``device`` mode run (rtol
    1e-5, atol 1e-6, as above). A resume from ``iter_2`` at three steps a
    dispatch takes one step to the next log and save point (3), then one
    to the end."""
    device = _run(cube_data, str(tmp_path / "a"), data_loader_mode="device")
    cached = _run(cube_data, str(tmp_path / "b"), save_interval=2)
    _close(_params(cached), _params(device), 1e-5, 1e-6)
    resumed = _run(cube_data, str(tmp_path / "c"), iters=4, log_iters=3,
                   save_interval=3, steps_per_dispatch=3,
                   resume_model=str(tmp_path / "b" / "iter_2"))
    assert resumed.step == 4
    assert sorted(os.listdir(tmp_path / "c")) == ["iter_3", "iter_4"]


def test_profiler_options_trace_a_window_of_the_loop(tmp_path, cube_data):
    train_profiler.reset()
    out = tmp_path / "trace"
    try:
        state = _run(cube_data, str(tmp_path / "a"), steps_per_dispatch=2,
                     profiler_options="batch_range=[1,3];profile_path={};"
                     "exit_on_finished=false".format(out))
    finally:
        train_profiler.reset()
    assert state.step == 4
    assert os.path.getsize(out / "trace.json") > 0


@pytest.mark.parametrize("options", [
    "batch_range=[50,60];profile_path=/x/p;exit_on_finished=false;"
    "tracer_option=OpDetail",
    "batch_range=[5, 3];exit_on_finished=yes;state=GPU;sorted_key=max",
    " batch_range = [0,1] ; profile_path=p ; exit_on_finished=0 ;",
])
def test_profiler_options_parse_as_the_jax_class(options):
    ours = train_profiler.ProfilerOptions(options)
    ref = jprofiler.ProfilerOptions(options)
    for key in ("batch_range", "state", "sorted_key", "tracer_option",
                "exit_on_finished"):
        assert ours[key] == ref[key], key
    if "profile_path" in options:
        assert ours["profile_path"] == ref["profile_path"]
    with pytest.raises(ValueError):
        ours["nope"]


# --------------------------------------------------------------------------
# the optimizers a graph can replay
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_capturable_optimizers_match_optax_and_torch_for_20_steps(tmp_path,
                                                                  name):
    """The config's optimizer block in its capturable form (the learning
    rate a tensor, set by ``set_lr``) against the optax chain the JAX
    package builds and against the eager form with a float learning rate,
    over 20 updates of a PolynomialDecay on a toy parameter (float32;
    1e-5 for 20 rounded updates of O(1) entries)."""
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
    ours = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    eager = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tconfig.capturable(cfg.build_optimizer([ours]))
    ref = cfg.build_optimizer([eager])
    assert tconfig.is_capturable(opt)
    assert all(torch.is_tensor(g["lr"]) for g in opt.param_groups)
    assert tconfig.capturable(opt) is opt
    for i in range(20):
        upd, opt_state = tx.update(jnp.asarray(grads[i]), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for o, p in ((opt, ours), (ref, eager)):
            tconfig.set_lr(o, cfg.lr_scheduler(i))
            p.grad = torch.from_numpy(grads[i].copy())
            o.step()
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))
        np.testing.assert_allclose(ours.detach().numpy(),
                                   eager.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=str(i))


def test_capturable_refuses_what_it_cannot_replay():
    p = torch.nn.Parameter(torch.zeros(3))
    used = torch.optim.SGD([p], lr=0.1, momentum=0.9)
    p.grad = torch.ones(3)
    used.step()
    with pytest.raises(ValueError, match="before its first update"):
        tconfig.capturable(used)
    with pytest.raises(ValueError, match="dampening"):
        tconfig.capturable(torch.optim.SGD([p], lr=0.1, momentum=0.9,
                                           dampening=0.5))
    with pytest.raises(ValueError, match="no capturable form"):
        tconfig.capturable(torch.optim.Adagrad([p], lr=0.1))
    assert not tconfig.is_capturable(torch.optim.SGD([p], lr=0.1))
