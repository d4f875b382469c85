"""The rest of the port's process mesh (medicalseg_torch.parallel) against
the JAX package's mesh and against the port's one process, on the CPU.

* (C) H blocks that the strides do not divide: a V-Net at 16^3 (H 16 ->
  8 -> 4 -> 2 -> 1; over space 2 the deepest level's single row is
  replicated) and at 16 x 80 x 16 (H 80 -> ... -> 10 -> 5; the deepest
  level's five rows do not divide over space 2), one train step and
  ``evaluate`` each;
* (D) a V-Net whose third down conv has an H window of 3 over a stride
  of 1 (16 x 32 x 16: H 32 -> 16 -> 8 -> 6 -> 3; the window would reach 2
  rows into the successor's block, so the conv joins the blocks and the
  levels below it run replicated), one step; ``BCELoss`` with no weight, ``weight='dynamic'`` and
  ``pos_weight='dynamic'`` over the mesh;
* (B) the host loader over data 4, data 2 x space 2 and space 4 (each
  rank's rows bit for bit the one-process loader's), its draws against
  the JAX host transforms' by two-sample tests, and ``core.train.train``
  in host mode over data 2 x space 2 against one process;
* (A) the graphed sharded step's choice of graph by backend, and its
  capture's collectives against its warm-up's, on a stub mesh (stub
  collectives, CUDA streams and graphs: a real capture needs the card).

The ranks are one launch of four gloo ranks of tests/_torch_dist.py
(data 2 x space 2 unless a case says otherwise); the port's one-process
references are the same jobs on one rank, launched beside them; the JAX
references (the step jitted over a 2 x 2 virtual-device mesh with the JAX
train loop's shardings, ``evaluate`` on one device) run in this process
meanwhile. The V-Nets start from their seeded initialisation.

The global batch of the 16^3 step is 4: at a batch of 2 the deepest
BatchNorm normalises two values a channel, whose output is +-1 whatever
they are, so that its gradient is rounding noise in either package.

Tolerances (float32), those of tests/test_torch_parallel.py: the step
against the JAX mesh loss rtol 2e-4, gradients atol 5e-4 / rtol 5e-3,
BatchNorm statistics atol 5e-3 / rtol 2e-2; against the port's one
process loss rtol 1e-5, gradients, parameters and statistics atol 1e-5;
``evaluate`` mDice rtol 1e-4 and the dumped prediction equal; BCELoss
(one reduction over the world, in another order) loss rtol 1e-5 and
gradient atol 1e-7 against both; the host-mode train against one process
atol 1e-5 (test_torch_parallel.py's CLI bound).
"""
import contextlib
import copy
import functools
import os
import sys
import types

import numpy as np
import pytest
from scipy import stats

import jax
import jax.numpy as jnp
import optax
import torch

from medicalseg_tpu.core import evaluate as jevaluate
from medicalseg_tpu.core import state as jstate
from medicalseg_tpu.datasets import MedicalDataset as JMedicalDataset
from medicalseg_tpu.models import VNet as JVNet
from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.parallel import mesh as jmesh
from medicalseg_tpu.transforms import transform as jtransform
from medicalseg_torch.core import state as tstate
from medicalseg_torch.core.state import TrainState
from medicalseg_torch.models import VNet
from medicalseg_torch.parallel import Mesh, h_levels, shard_batch, use_mesh
from medicalseg_torch.transforms import transform as ttransform
from medicalseg_torch.utils import transplant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_dist as td  # noqa: E402
from test_torch_train_loop import _spine_yaml, _write_dataset  # noqa: E402

# the third down conv: H window 3 over stride 1 (and the up conv's)
LONG = dict(kernel_size=[[2, 2, 2], [2, 2, 2], [2, 3, 2], [2, 2, 2]],
            stride_size=[[2, 2, 2], [2, 2, 2], [2, 1, 2], [2, 2, 2]])
# name: (global batch shape, model keys, the JAX step it is held to: over
# the 2 x 2 mesh, on one device, or none)
STEPS = {"c16": ((4, 16, 16, 16), {}, "one device"),
         "c16_dropout": ((4, 16, 16, 16), {"dropout": True}, None),
         "c80": ((2, 16, 80, 16), {}, "mesh"),
         "long": ((2, 16, 32, 16), LONG, "mesh")}
EVALS = {"e16": (16, 16, 16), "e80": (16, 80, 16)}
BCE_FORMS = {"plain": {}, "weight": {"weight": "dynamic"},
             "pos_weight": {"pos_weight": "dynamic"}}
LOADER_SPACES = (1, 2, 4)  # data 4, data 2 x space 2, space 4
DRAWS = 3000  # draws of each side of a two-sample test
LEVEL = 1e-3  # the two-sample tests' level


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# inputs and references
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _vnet(long):
    """A V-Net of two classes at its seeded start, built once (a V-Net
    takes seconds to initialise on one thread; dropout does not change
    its weights): copy it before use."""
    return VNet(num_classes=2, dropout=False, **(LONG if long else {}))


def _step_payload(name):
    """A step case: the model keys, the global batch; the workers build the
    seeded start themselves."""
    shape, model, _ = STEPS[name]
    rng = np.random.RandomState(7)
    images = rng.rand(*shape, 1).astype(np.float32)
    labels = rng.randint(0, 2, shape).astype(np.int64)
    return dict(model=dict(dict(num_classes=2, dropout=False), **model),
                deepsup=False, seed=5, images=torch.from_numpy(images),
                labels=torch.from_numpy(labels))


def _jax_tx():
    return optax.chain(
        optax.add_decayed_weights(1e-4),
        optax.sgd(optax.polynomial_schedule(0.01, 0.0, 0.9, 20),
                  momentum=0.9))


def _jax_step(p, on):
    """The JAX step from the port's start weights, jitted ``on`` a 2 x 2
    ("data", "space") mesh of virtual devices with the JAX train loop's
    shardings (images H-sharded) or on one device: (gradients, BatchNorm
    statistics after, loss)."""
    start = transplant.flax_from_state_dict(
        _vnet("kernel_size" in p["model"]).state_dict())
    model = JVNet(in_channels=1, **p["model"])
    tx = _jax_tx()
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=start["params"],
        batch_stats=start["batch_stats"], opt_state=tx.init(start["params"]),
        apply_fn=model.apply, tx=tx)
    losses = {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}
    args = (p["images"].numpy(), p["labels"].numpy().astype(np.int32),
            jax.random.PRNGKey(0))
    if on == "mesh":
        mesh = jmesh.build_mesh(2, 2, devices=jax.devices()[:4])
        repl = jmesh.replicated(mesh)
        step = jax.jit(jstate.make_train_step(losses), in_shardings=(
            repl, jmesh.batch_sharding(mesh), jmesh.label_sharding(mesh),
            repl))
        with mesh:
            state, metrics = step(jax.device_put(state, repl), *args)
    else:
        state, metrics = jax.jit(jstate.make_train_step(losses))(state,
                                                                 *args)
    trace = [s.trace for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "trace"))
        if hasattr(s, "trace")][0]
    grads = jax.tree_util.tree_map(lambda t, w: t - 1e-4 * w,
                                   jax.device_get(trace), start["params"])
    return {"grads": grads, "batch_stats": jax.device_get(state.batch_stats),
            "loss": float(metrics["loss"])}


@functools.lru_cache(maxsize=None)
def _eval_weights():
    """The seeded V-Net with BatchNorm statistics off their start."""
    rng = np.random.RandomState(3)
    sd = {k: v.clone() for k, v in _vnet(False).state_dict().items()}
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            sd[k] = torch.from_numpy((0.5 + rng.rand(*sd[k].shape)).astype(
                np.float32))
    return sd


def _val_setup(root, shape, pt):
    """Two val volumes of ``shape``, the weights (a port ``.pt`` at
    ``pt``, written once) and the val YAML."""
    import yaml
    phase0 = _write_dataset(str(root), shape, 2, 2)
    sd = _eval_weights()
    if not os.path.exists(pt):
        torch.save(sd, pt)
    cfg = {"batch_size": 1, "iters": 10,
           "val_dataset": {"type": "MedicalDataset", "dataset_root": phase0,
                           "result_dir": phase0, "num_classes": 2,
                           "transforms": [], "mode": "val"},
           "optimizer": {"type": "sgd", "momentum": 0.9},
           "lr_scheduler": {"type": "PolynomialDecay",
                            "learning_rate": 0.001, "decay_steps": 10,
                            "end_lr": 0, "power": 0.9},
           "loss": {"types": [{"type": "MixedLoss", "losses": [
               {"type": "CrossEntropyLoss", "weight": None},
               {"type": "DiceLoss"}], "coef": [1, 1]}], "coef": [1]},
           "model": {"type": "VNet", "in_channels": 1, "num_classes": 2}}
    yml = str(root / "val.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(cfg, f)
    return phase0, sd, pt, yml


def _eval_losses(lib):
    return {"types": [lib.MixedLoss([lib.CrossEntropyLoss(),
                                     lib.DiceLoss()], [1, 1])],
            "coef": [1]}


def _bce_payload():
    rng = np.random.RandomState(21)
    labels = rng.randint(0, 3, (2, 4, 8, 6))
    labels[rng.rand(*labels.shape) < 0.1] = 255  # ignored voxels
    return {"logits": torch.from_numpy(
        rng.randn(2, 4, 8, 6, 3).astype(np.float32) * 2),
            "labels": torch.from_numpy(labels)}


def _loader_payload(root):
    phase0 = _write_dataset(str(root), (12, 24, 20), 5, 3)
    return {"phase0": phase0, "size": (8, 16, 16), "batch": 4, "seed": 3,
            "n": 3}


def _jobs(inputs, tmp, one):
    """The jobs of every case, ``one``: as the one-process references (on
    a mesh of one rank) instead of over the mesh. Returns (names, jobs)."""
    tag = "one" if one else "port"
    named = [(name, ("step", 2, p)) for name, p in inputs["steps"].items()]
    named += [(name, ("evaluate", 2, {
        "config": yml, "model_path": pt,
        "out": str(tmp / "{}_{}".format(tag, name))}))
        for name, (_, _, pt, yml) in inputs["evals"].items()]
    named += [("bce_" + form, ("bce", 2, dict(inputs["bce"], kw=kw)))
              for form, kw in BCE_FORMS.items()]
    spaces = (1,) if one else LOADER_SPACES
    named += [("loader_space{}".format(space), ("loader", space,
                                                inputs["loader"]))
              for space in spaces]
    train = dict(inputs["train"], out=str(tmp / (tag + "_train")))
    if one:  # the global batch in one process
        train["batch"] *= 2
    named.append(("train", ("train", 2, train)))
    if one:  # a mesh of one rank
        named = [(n, (job, 1, p)) for n, (job, _, p) in named]
    return [n for n, _ in named], [j for _, j in named]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on four CPU ranks and, beside them, on one; the JAX
    references computed in this process while they run. Returns (per rank
    a dict of each case's result, the one-process results, the JAX
    references, the inputs)."""
    tmp = tmp_path_factory.mktemp("shapes")
    inputs = {"steps": {name: _step_payload(name) for name in STEPS},
              "evals": {name: _val_setup(tmp_path_factory.mktemp(name),
                                         shape, str(tmp / "model.pt"))
                        for name, shape in EVALS.items()},
              "bce": _bce_payload(), "loader": _loader_payload(tmp / "ld"),
              "tmp": tmp}
    phase0 = _write_dataset(str(tmp / "spine"), (8, 32, 32), 2, 20)
    inputs["train"] = {"config": _spine_yaml(tmp, phase0), "iters": 2,
                       "batch": 1}
    names, jobs = _jobs(inputs, tmp, one=False)
    handle = td.start(tmp / "ranks", jobs, world=4)
    try:
        one_names, one_jobs = _jobs(inputs, tmp, one=True)
        one_handle = td.start(tmp / "one", one_jobs, world=1)
        try:
            jax_refs = _jax_references(inputs, tmp)
        finally:
            one = dict(zip(one_names, td.finish(one_handle, 600)[0]))
    finally:
        out = td.finish(handle, timeout=600)
    return [dict(zip(names, rank)) for rank in out], one, jax_refs, inputs


def _jax_references(inputs, tmp):
    refs = {"steps": {n: _jax_step(p, STEPS[n][2])
                      for n, p in inputs["steps"].items() if STEPS[n][2]},
            "evals": {}}
    for name, (phase0, sd, _, _) in inputs["evals"].items():
        flax_vars = transplant.flax_from_state_dict(sd)
        jmodel = JVNet(in_channels=1, num_classes=2)
        jstate_ = jstate.TrainState(
            step=jnp.zeros((), jnp.int32), params=flax_vars["params"],
            batch_stats=flax_vars["batch_stats"], opt_state=None,
            apply_fn=jmodel.apply, tx=None)
        jds = JMedicalDataset(phase0, phase0, [], 2, mode="val")
        refs["evals"][name] = jevaluate(
            jstate_, jds, _eval_losses(jlosses),
            save_dir=str(tmp / ("jax_" + name)), print_detail=False)
    return refs


# --------------------------------------------------------------------------
# (C), (D) one train step
# --------------------------------------------------------------------------
def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


@pytest.mark.parametrize("name", list(STEPS))
def test_step_over_uneven_h_blocks_matches_one_process(runs, name):
    """Every rank takes the single-process update and metrics: the
    replicated region's BatchNorm, dropout rows, gathers and the up conv's
    way out of it give the global batch's step."""
    ranks, one, _, _ = runs
    ref = one[name]
    for got in ranks:
        got = got[name]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        torch.testing.assert_close(got["dice"], ref["dice"], rtol=1e-5,
                                   atol=1e-6)
    assert max(got[name]["diff_to_rank0"] for got in ranks[1:]) <= 1e-6
    got = ranks[0][name]
    assert got["grads"].keys() == ref["grads"].keys()
    for k, v in ref["grads"].items():
        torch.testing.assert_close(got["grads"][k], v, rtol=0, atol=1e-5,
                                   msg=k)
    for k, v in ref["state"].items():
        torch.testing.assert_close(got["state"][k].float(), v.float(),
                                   rtol=0, atol=1e-5, msg=k)


@pytest.mark.parametrize("name", [n for n in STEPS if STEPS[n][2]])
def test_step_over_uneven_h_blocks_matches_the_jax_step(runs, name):
    """Against the JAX step over the 2 x 2 mesh; at 16^3 against the JAX
    step on one device: there the JAX mesh program differs from its own
    one-device step (where a shard holds fewer rows than the conv's 2-row
    halo, ``_halo_h_kl`` sends ``x[..., -2:]`` of a 1-row shard), and the
    port, which gathers such short blocks, holds the one-device step."""
    ranks, _, jax_refs, inputs = runs
    want = jax_refs["steps"][name]
    for got in ranks:
        np.testing.assert_allclose(got[name]["loss"], want["loss"],
                                   rtol=2e-4)
    got = ranks[0][name]  # the others hold the same
    model = copy.deepcopy(_vnet("kernel_size" in inputs["steps"][name][
        "model"]))
    for key, prm in model.named_parameters():
        prm.grad = got["grads"][key]
    ours = _leaves(transplant.grads_to_flax(model))
    theirs = _leaves(want["grads"])
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (key, a), (_, b) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=5e-3,
                                   err_msg=key)
    moved = transplant.flax_from_state_dict(got["state"])
    stats_ = _leaves(moved["batch_stats"])
    assert len(stats_) == 2 * 24
    for (key, a), (_, b) in zip(stats_, _leaves(want["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-3, rtol=2e-2,
                                   err_msg=key)


def test_h_levels_replicate_from_the_first_uneven_level():
    """The plan of each case over space 2: H-sharded levels while the
    blocks hold whole strides and the windows stay inside them, the
    replicated view of the mesh from the first level that does not on."""
    mesh = Mesh(2, 2, 0)
    forms = {}
    for name, (shape, model, _) in STEPS.items():
        net = _vnet("kernel_size" in model)
        xk = torch.zeros(1, 1, 1, shape[2] // 2, 1)
        assert net.h_levels(xk) == [None] * 5  # no mesh is active
        with use_mesh(mesh):
            levels = net.h_levels(xk)
        assert levels[0] is mesh
        assert all(lv is mesh or lv is mesh.whole() for lv in levels)
        forms[name] = [lv.whole_h for lv in levels]
    assert forms["c16"] == forms["c80"] == [False] * 4 + [True]
    assert forms["c16_dropout"] == forms["c16"]
    assert forms["long"] == [False] * 3 + [True] * 2
    assert h_levels(mesh, 32, [(2, 2)] * 4) == [mesh] * 5
    data = Mesh(4, 1, 0)  # no space axis: nothing to replicate
    assert h_levels(data, 5, [(3, 1), (2, 2)]) == [data] * 3
    assert mesh.whole().splits_h is False and mesh.splits_h
    assert mesh.whole().whole() is mesh.whole()


def test_an_input_h_that_does_not_divide_raises_as_the_jax_mesh_does():
    """The replicated levels start below the input: an input whose H does
    not divide over space is refused, as the JAX ``shard_batch`` refuses
    it (its ``device_put`` cannot place uneven shards)."""
    images = np.zeros((2, 4, 81, 4, 1), np.float32)
    labels = np.zeros((2, 4, 81, 4), np.int32)
    ref = jmesh.build_mesh(2, 2, devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        jmesh.shard_batch(ref, images, labels)
    for rank in range(4):
        with pytest.raises(ValueError, match="H = 81"):
            shard_batch(Mesh(2, 2, rank), torch.from_numpy(images),
                        torch.from_numpy(labels))


# --------------------------------------------------------------------------
# (C) evaluate
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(EVALS))
def test_evaluate_over_uneven_h_blocks_matches_jax_and_one_process(runs,
                                                                   name):
    ranks, one, jax_refs, inputs = runs
    want, one = jax_refs["evals"][name], one[name]
    results = [got[name] for got in ranks]
    for result in results:
        assert result == results[0]
        for key in ("mdice", "mdice_hard"):
            np.testing.assert_allclose(result[key], want[key], rtol=1e-4,
                                       err_msg=key)
            np.testing.assert_allclose(result[key], one[key], rtol=1e-4,
                                       err_msg=key)
    # rank 0 alone dumps: its share is volume 0
    tmp = inputs["tmp"]
    assert sorted(os.listdir(tmp / ("port_" + name))) == ["rank0"]
    np.testing.assert_array_equal(
        np.load(tmp / ("port_" + name) / "rank0" / "0" / "pred.npy"),
        np.load(tmp / ("jax_" + name) / "0" / "pred.npy"))


# --------------------------------------------------------------------------
# (D) BCELoss
# --------------------------------------------------------------------------
def _jax_bce(p, kw):
    logits = jnp.asarray(p["logits"].numpy())
    labels = jnp.asarray(p["labels"].numpy().astype(np.int32))
    loss, grad = jax.value_and_grad(
        lambda x: jlosses.BCELoss(**kw)(x, labels))(logits)
    return float(loss), np.asarray(grad)


def _assembled(ranks, case):
    """The ranks' gradient blocks (data 2 x space 2, NDHWC) joined."""
    return torch.cat([torch.cat([ranks[2 * d + s][case]["grad"]
                                 for s in range(2)], 2) for d in range(2)])


@pytest.mark.parametrize("form", list(BCE_FORMS))
def test_bce_loss_over_the_mesh_matches_jax_and_one_process(runs, form):
    ranks, one, _, inputs = runs
    loss, grad = _jax_bce(inputs["bce"], BCE_FORMS[form])
    case = "bce_" + form
    one = one[case]
    np.testing.assert_allclose(one["loss"], loss, rtol=1e-5)
    for got in ranks:
        np.testing.assert_allclose(got[case]["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got[case]["loss"], one["loss"],
                                   rtol=1e-5)
    ours = _assembled(ranks, case)
    np.testing.assert_allclose(ours.numpy(), grad, rtol=0, atol=1e-7)
    torch.testing.assert_close(ours, one["grad"], rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# (B) host-mode loading over the mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("space", LOADER_SPACES)
def test_host_loader_rows_are_the_one_process_batches(runs, space):
    """Each rank makes its rows of the global batch, bit for bit the
    one-process host loader's, whatever its worker threads' order; the
    ranks of one data index make the same rows."""
    ranks, one, _, _ = runs
    want = one["loader_space1"]
    data = 4 // space
    per = want[0][0].shape[0] // data
    for r, got in enumerate(ranks):
        d = r // space
        for (images, labels), (want_i, want_l) in zip(
                got["loader_space{}".format(space)], want):
            assert torch.equal(images, want_i[d * per:(d + 1) * per])
            assert torch.equal(labels, want_l[d * per:(d + 1) * per])
    # the batches are not all alike: the draws moved
    assert not torch.equal(want[0][0], want[1][0])


def _port_draws(n):
    rng = np.random.default_rng(0)
    crop = [ttransform._draw_crop_box((40, 48, 56), (0.3, 1.0),
                                      (0.75, 1.33), rng) for _ in range(n)]
    pre = [ttransform._draw_precrop_box((40, 48, 56), (0.8, 1.2),
                                        (24, 24, 24), rng) for _ in range(n)]
    rot = [ttransform._draw_rotation((-30, 30), [[0, 1], [0, 2], [1, 2]],
                                     rng) for _ in range(n)]
    flip = [ttransform._draw_flip([0, 1, 2], 0.5, rng) for _ in range(n)]
    return crop, pre, rot, flip


def _jax_draws(n):
    import random
    random.seed(0)
    np.random.seed(0)
    crop = [jtransform._draw_crop_box((40, 48, 56), (0.3, 1.0),
                                      (0.75, 1.33)) for _ in range(n)]
    pre = [jtransform._draw_precrop_box((40, 48, 56), (0.8, 1.2),
                                        (24, 24, 24)) for _ in range(n)]
    rot = [jtransform._draw_rotation((-30, 30), [[0, 1], [0, 2], [1, 2]])
           for _ in range(n)]
    flip = [jtransform._draw_flip([0, 1, 2], 0.5) for _ in range(n)]
    return crop, pre, rot, flip


def _chi2(a, b):
    values = sorted(set(a) | set(b), key=str)
    table = [[sum(x == v for x in a) for v in values],
             [sum(x == v for x in b) for v in values]]
    return stats.chi2_contingency(table)[1]


def test_host_draws_follow_the_jax_host_transforms():
    """The generator-fed draws against the JAX host transforms' (python
    ``random`` and numpy's global generator): two-sample tests of every
    drawn quantity."""
    ours, ref = _port_draws(DRAWS), _jax_draws(DRAWS)
    p = {}
    for f, key in enumerate(("i", "j", "k", "d", "h", "w")):
        p["crop." + key] = stats.ks_2samp([c[f] for c in ours[0]],
                                          [c[f] for c in ref[0]]).pvalue
    for part, name in ((0, "start"), (1, "extent")):
        for ax in range(3):
            p["pre.{}[{}]".format(name, ax)] = stats.ks_2samp(
                [x[part][ax] for x in ours[1]],
                [x[part][ax] for x in ref[1]]).pvalue
    p["angle"] = stats.ks_2samp([a for a, _ in ours[2]],
                                [a for a, _ in ref[2]]).pvalue
    p["plane"] = _chi2([str(pl) for _, pl in ours[2]],
                       [str(pl) for _, pl in ref[2]])
    p["flip"] = _chi2(ours[3], ref[3])
    assert min(p.values()) > LEVEL, p
    assert len({c.d for c in ours[0]}) > 5  # the draws spread


def test_host_mode_train_over_the_mesh_equals_one_process(runs):
    """``train`` with the host loader over data 2 x space 2 (the spine
    recipe's rotation and flip drawn on the host, two loader threads) ends
    where the one-process run at the same global batch ends, on every
    rank."""
    ranks, one, _, _ = runs
    assert max(got["train"]["diff_to_rank0"] for got in ranks[1:]) <= 1e-6
    got, want = ranks[0]["train"], one["train"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-5, msg=k)


# --------------------------------------------------------------------------
# (A) the graphed sharded step, on a stub mesh
# --------------------------------------------------------------------------
def test_updates_replay_the_graph_on_the_card_over_nccl_only():
    run = tstate._Updates(td._losses(1), None, None)
    card = types.SimpleNamespace(is_cuda=True)
    host = types.SimpleNamespace(is_cuda=False)
    assert run.replays(card) and not run.replays(host)
    for backend, graphed in (("nccl", True), ("gloo", False)):
        run = tstate._Updates(td._losses(1), None, None,
                              Mesh(2, 2, 0, backend))
        assert run.replays(card) is graphed
        assert not run.replays(host)
        assert run.graphed.mesh is run.mesh
    one = tstate._Updates(td._losses(1), None, None, Mesh(1, 1, 0, "nccl"))
    assert one.mesh is None and one.replays(card)


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def register_generator_state(self, generator):
        self.generator = generator

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _stub_cuda_and_collectives(monkeypatch, log):
    """CUDA streams and graphs that run on the CPU, and collectives that
    record (phase, kind, shape, group) into ``log`` and compute the one
    rank's values (an all-reduce keeps them, an all-gather repeats the
    block, a receive gets zeros)."""
    import torch.distributed as dist
    phase = ["eager"]

    @contextlib.contextmanager
    def graph(g, capture_error_mode="global"):
        log.append(("begin", capture_error_mode))
        phase[0] = "capture"
        yield
        phase[0] = "after"

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)

    def all_reduce(t, group=None, **kw):
        log.append((phase[0], "all_reduce", tuple(t.shape), group))

    def all_gather(parts, part, group=None, **kw):
        log.append((phase[0], "all_gather", tuple(part.shape), group))
        for p in parts:
            p.copy_(part)

    def batch_isend_irecv(ops):
        log.append((phase[0], "p2p", tuple(op.tensor.shape for op in ops),
                    None))
        return []

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "batch_isend_irecv", batch_isend_irecv)
    monkeypatch.setattr(dist, "P2POp", lambda op, tensor, peer: types.
                        SimpleNamespace(op=op, tensor=tensor, peer=peer))
    yield


@functools.lru_cache(maxsize=None)
def _capture_log(rank):
    """The collectives of one graphed sharded step of rank ``rank`` of a
    data 2 x space 2 stub mesh (NCCL), a capture and then a replay:
    (log, number of entries after the capture, the step, its state)."""
    log = []
    p = _step_payload("c16")
    mesh = Mesh(2, 2, rank, "nccl", space_group="space", data_group="data")
    with pytest.MonkeyPatch.context() as monkeypatch, \
            _stub_cuda_and_collectives(monkeypatch, log):
        state = TrainState.create(
            copy.deepcopy(_vnet(False)), lambda ps: torch.optim.SGD(
                ps, lr=0.01, momentum=0.9), lambda step: 0.01, seed=5,
            device="cpu", capturable_optimizer=True)
        lo, hi = mesh.rows(1)
        images, labels = tstate._prepare(state, p["images"][lo:hi],
                                         p["labels"][lo:hi], None, mesh)
        step = tstate.GraphedStep(td._losses(1), mesh=mesh)
        step(state, images.contiguous(), labels.contiguous())
        n = len(log)
        step(state, images.contiguous(), labels.contiguous())
    return log, n, step, state


@pytest.mark.parametrize("rank", [0, 3])
def test_capture_runs_the_warm_ups_collectives_in_order(rank):
    """The capture records the collectives the eager warm-up ran, in the
    same order and at the same shapes (so every communicator exists before
    it), on every rank alike: halo exchanges, the gathers where a block is
    shorter than the halo or enters the replicated level, BatchNorm and
    loss all-reduces, and ``sum_grads`` last; a replay runs none from the
    host."""
    log, n, step, state = _capture_log(rank)
    assert len(log) == n and step.replays == 1 == step.graph.replays
    begin = log.index(("begin", "thread_local"))
    warm, capture = log[:begin], log[begin + 1:]
    assert [e[0] for e in warm] == ["eager"] * len(warm)
    assert [e[0] for e in capture] == ["capture"] * len(capture)
    assert [e[1:] for e in warm] == [e[1:] for e in capture]
    assert {"p2p", "all_gather", "all_reduce"} <= {e[1] for e in warm}
    assert ("all_gather", "space") in {(e[1], e[3]) for e in warm}
    n_params = sum(prm.numel() for prm in state.model.parameters())
    assert warm[-1][1:] == ("all_reduce", (n_params,), None)  # sum_grads
    rank0 = _capture_log(0)[0]
    assert [e[1:3] for e in log] == [e[1:3] for e in rank0]
