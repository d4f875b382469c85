"""The port's process mesh (medicalseg_torch.parallel) against the JAX
package's mesh and sharded programs, on the CPU.

The ranks are fresh processes of tests/_torch_dist.py (torch and
medicalseg_torch only) on a gloo group through a FileStore under the
test's temporary directory. One launch of four ranks runs every sharded
case of the port once a module (the halo at space 2 and 4, the conv5 op
at data 2 x space 2 in both kinds, one VNet train step at data 2 x space
2, VNetDeepSup at the spine geometry at space 2, ``evaluate`` at data 4
and at data 2 x space 2), and each test reads its part; the JAX
references also run once a module. ``torchrun`` runs the train CLI at
world 2 (``test_train_cli_at_world_2_...``).

Tolerances (float32 throughout):
  * the halo: bit for bit against slicing the zero-padded global tensor;
    its backward at atol 1e-6 (a row's cotangent is its own plus its
    neighbours' halo copies, added in another order);
  * the conv5 op against ``pallas_conv5.conv5`` / ``conv5_kl_fused``
    under a JAX 2 x 2 mesh with ``interpret=True``: y, fused y and dx at
    atol 1e-4, dW and db at atol 2e-4 (sums of up to 768 products, and
    over the world, in another order);
  * the train step against the JAX ``make_train_step`` on one device at
    the global batch: test_torch_train.py's bounds (loss rtol 2e-4,
    gradients atol 5e-4 / rtol 5e-3, BatchNorm statistics atol 5e-3 /
    rtol 2e-2); against the port's single-process step: loss rtol 1e-5,
    gradients atol 1e-5, parameters and statistics atol 1e-5 (the same
    sums cut into shards);
  * ``evaluate`` against the JAX ``evaluate``: mDice rtol 1e-4
    (test_torch_eval.py's), the dumped prediction equal;
  * the CLI: the world-2 run's checkpoint equals the single-process
    run's at atol 1e-5.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

from medicalseg_tpu.core import evaluate as jevaluate
from medicalseg_tpu.core import loader as jloader
from medicalseg_tpu.core import state as jstate
from medicalseg_tpu.datasets import MedicalDataset as JMedicalDataset
from medicalseg_tpu.models import VNet as JVNet
from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.ops import pallas_conv5 as pc
from medicalseg_tpu.parallel import mesh as jmesh
from medicalseg_tpu.transforms import RandomFlip3D as JRandomFlip3D
from medicalseg_torch.core import loader as tloader
from medicalseg_torch.core.state import make_train_step
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.datasets import MedicalDataset
from medicalseg_torch.models import VNet, VNetDeepSup
from medicalseg_torch.parallel import mesh as tmesh
from medicalseg_torch.transforms import RandomFlip3D
from medicalseg_torch.utils import checkpoint as tckpt
from medicalseg_torch.utils import transplant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_dist as td  # noqa: E402
from test_torch_eval import (_datasets, _losses, _val_yaml,  # noqa: E402
                             _write_val_root)
from test_torch_train_loop import _spine_yaml, _write_dataset  # noqa: E402

VNET_SHAPE = (2, 16, 32, 16)  # the global batch: H 32 -> 1 row a shard
SPINE_SHAPE = (2, 8, 32, 32)  # two spine samples of (8, 32, 32)
CONV_SHAPE = (2, 4, 8, 8)  # N, D, H, W of the conv5 op


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# inputs and the JAX references, once a module
# --------------------------------------------------------------------------
def _conv_case(kind):
    ci, co = (4, 3) if kind == "head" else (1, 4)
    rng = np.random.RandomState(11 if kind == "head" else 12)
    n, d, h, w = CONV_SHAPE
    return {"x": rng.randn(n, d, h, w, ci).astype(np.float32),
            "w": (rng.randn(5, 5, 5, ci, co) / 15).astype(np.float32),
            "b": rng.randn(co).astype(np.float32),
            "g": rng.randn(n, d, h, w, co).astype(np.float32),
            "ep": [(0.5 + rng.rand(co)).astype(np.float32),
                   rng.randn(co).astype(np.float32),
                   (0.1 + rng.rand(co) / 2).astype(np.float32)]}


def _kl(a):
    """NDHWC numpy -> kernel-layout torch [N, D, C, H, W]."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 1, 4, 2, 3))))


@functools.lru_cache(maxsize=None)
def _jax_conv(kind):
    """``pallas_conv5.conv5`` (y, dx, dW, db) and ``conv5_kl_fused`` under
    a JAX 2 x 2 ("data", "space") mesh, interpret mode."""
    c = _conv_case(kind)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                 ("data", "space"))
    xs = jax.device_put(jnp.asarray(c["x"]),
                        NamedSharding(mesh, PS("data", None, "space")))
    y, vjp = jax.vjp(lambda x, k, b: pc.conv5(x, k, b, kind, True), xs,
                     jnp.asarray(c["w"]), jnp.asarray(c["b"]))
    dx, dw, db = vjp(jnp.asarray(c["g"]))
    xk = jax.device_put(jnp.transpose(jnp.asarray(c["x"]), (0, 1, 4, 2, 3)),
                        NamedSharding(mesh, PS("data", None, None, "space")))
    yf = jax.jit(lambda x: pc.conv5_kl_fused(
        x, jnp.asarray(c["w"]), jnp.asarray(c["b"]),
        tuple(jnp.asarray(v) for v in c["ep"]), kind, True))(xk)
    return {k: np.asarray(v) for k, v in
            dict(y=y, dx=dx, dw=dw, db=db, yf=yf).items()}


def _step_batch(shape, classes, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape, 1).astype(np.float32),
            rng.randint(0, classes, shape).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_vnet_step():
    """The JAX trainer's start and one step at the global batch, one
    device: (start variables, metrics, trace, variables after)."""
    images, labels = _step_batch(VNET_SHAPE, 2, 7)
    model = JVNet(in_channels=1, num_classes=2, dropout=False)
    tx = optax.chain(
        optax.add_decayed_weights(1e-4),
        optax.sgd(optax.polynomial_schedule(0.01, 0.0, 0.9, 20),
                  momentum=0.9))
    state = jstate.TrainState.create(model, tx, jnp.asarray(images),
                                     jax.random.PRNGKey(3))
    start = jax.device_get(state.variables)
    losses = {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}
    state, metrics = jax.jit(jstate.make_train_step(losses))(
        state, jnp.asarray(images), jnp.asarray(labels),
        jax.random.PRNGKey(0))
    trace = [s.trace for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "trace"))
        if hasattr(s, "trace")][0]
    return (start, jax.device_get(metrics), jax.device_get(trace),
            jax.device_get(state.variables))


def _step_payload(deepsup):
    if deepsup:
        images, labels = _step_batch(SPINE_SHAPE, 3, 9)
        kw = dict(num_classes=3, dropout=True,
                  kernel_size=[[4, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
                  stride_size=[[1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2]])
        state_dict = VNetDeepSup(**kw).state_dict()
    else:
        images, labels = _step_batch(VNET_SHAPE, 2, 7)
        kw = dict(num_classes=2, dropout=False)
        state_dict = transplant.state_dict_from_flax(_jax_vnet_step()[0])
    return dict(model=kw, state_dict=state_dict, deepsup=deepsup, seed=5,
                images=torch.from_numpy(images),
                labels=torch.from_numpy(labels).long())


@functools.lru_cache(maxsize=None)
def _port_step(deepsup):
    """The port's single-process step at the global batch."""
    p = _step_payload(deepsup)
    state = td.make_state(p)
    state.generator.manual_seed(p["seed"])
    state, metrics = make_train_step(td._losses(4 if deepsup else 1))(
        state, p["images"], p["labels"])
    return td.step_result(state, metrics)


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    return _write_val_root(tmp_path_factory.mktemp("val32"), 32)


@pytest.fixture(scope="module")
def eval_setup(val_root, tmp_path_factory):
    """The JAX evaluate of a V-Net on the two 32^3 val volumes, and the
    same weights as a port ``.pt`` with its val YAML."""
    tmp = tmp_path_factory.mktemp("eval")
    model = JVNet(in_channels=1, num_classes=2)
    state = jstate.TrainState.create(model, optax.sgd(1e-3),
                                     jnp.zeros((1, 32, 32, 32, 1)),
                                     jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(jax.device_get(state.batch_stats)))
    state = state.replace(batch_stats=stats)
    jds, _ = _datasets(val_root)
    want = jevaluate(state, jds, _losses(jlosses), save_dir=str(tmp / "jax"),
                     print_detail=False)
    pt = str(tmp / "model.pt")
    torch.save(transplant.state_dict_from_flax(
        {"params": jax.device_get(state.params), "batch_stats": stats}), pt)
    return want, str(tmp / "jax"), _val_yaml(tmp, val_root), pt, tmp


@pytest.fixture(scope="module")
def ranks(eval_setup, tmp_path_factory):
    """Every sharded case, once, on four CPU ranks; per rank a dict of
    each case's result."""
    _, _, yml, pt, tmp = eval_setup
    rng = np.random.RandomState(5)
    jobs, names = [], []
    for space, h in ((2, 8), (4, 8), (4, 4)):
        x = torch.from_numpy(rng.randn(2, 3, 2, h, 5).astype(np.float32))
        g = torch.from_numpy(rng.randn(space, 2, 3, 2, h // space + 4,
                                       5).astype(np.float32))
        jobs.append(("halo", space, {"x": x, "g": g, "rows": 2}))
        names.append("halo{}_{}".format(space, h))
    for kind in ("head", "stem"):
        c = _conv_case(kind)
        jobs.append(("conv5", 2, {
            "kind": kind, "x": _kl(c["x"]), "g": _kl(c["g"]),
            "w": torch.from_numpy(c["w"]), "b": torch.from_numpy(c["b"]),
            "ep": tuple(torch.from_numpy(v) for v in c["ep"])}))
        names.append("conv5_" + kind)
    for deepsup in (False, True):
        jobs.append(("step", 2, _step_payload(deepsup)))
        names.append("step_deepsup" if deepsup else "step_vnet")
    for space in (1, 2):
        jobs.append(("evaluate", space, {
            "config": yml, "model_path": pt,
            "out": str(tmp / "port{}".format(space))}))
        names.append("evaluate_space{}".format(space))
    for mode, kw in (("sw2", {"sw_num": 2}), ("auc", {"auc_roc": True})):
        jobs.append(("evaluate", 2, dict(config=yml, model_path=pt,
                                         out=str(tmp / mode), **kw)))
        names.append("evaluate_" + mode)
    out = td.launch(tmp_path_factory.mktemp("ranks"), jobs, world=4,
                    timeout=420)
    return [dict(zip(names, rank)) for rank in out]


# --------------------------------------------------------------------------
# (a) the mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("data,space", [(4, 1), (2, 2), (1, 4), (4, 2)])
def test_rank_positions_follow_the_jax_device_mesh(data, space):
    n = data * space
    ref = jmesh.build_mesh(data, space, devices=jax.devices()[:n])
    assert dict(ref.shape) == tmesh.Mesh(data, space).shape
    for rank in range(n):
        m = tmesh.Mesh(data, space, rank)
        assert ref.devices[m.d, m.s].id == rank


def test_build_mesh_raises_the_jax_errors():
    one = jax.devices()[:1]
    for kw in ({"space": 2}, {"data": 2}, {"data": 1, "space": 3}):
        with pytest.raises(ValueError) as want:
            jmesh.build_mesh(devices=one, **kw)
        with pytest.raises(ValueError) as got:
            tmesh.build_mesh(**kw)
        assert str(got.value) == str(want.value)
    m = tmesh.build_mesh()
    assert (m.data, m.space, m.world, m.rank) == (1, 1, 1, 0)
    with tmesh.use_mesh(m) as active:  # one process is no mesh
        assert active is None and tmesh.active_mesh() is None


@pytest.mark.parametrize("items", [0, 1, 5, 8, 9])
@pytest.mark.parametrize("data,space", [(1, 2), (3, 1), (2, 2), (4, 2)])
def test_process_shard_matches_jax(monkeypatch, items, data, space):
    for rank in range(data * space):
        m = tmesh.Mesh(data, space, rank)
        monkeypatch.setattr(jax, "process_index", lambda: m.d)
        monkeypatch.setattr(jax, "process_count", lambda: data)
        assert tmesh.process_shard(items, m) == jmesh.process_shard(items)
    assert tmesh.process_shard(items) == (0, items)


def test_shard_batch_keeps_the_jax_shard_of_each_device():
    rng = np.random.RandomState(0)
    images = rng.rand(4, 3, 8, 5, 1).astype(np.float32)
    labels = rng.randint(0, 3, (4, 3, 8, 5)).astype(np.int32)
    ref = jmesh.build_mesh(2, 2, devices=jax.devices()[:4])
    ji, jl = jmesh.shard_batch(ref, images, labels)
    by_device = [{s.device.id: np.asarray(s.data)
                  for s in t.addressable_shards} for t in (ji, jl)]
    for rank in range(4):
        got = tmesh.shard_batch(tmesh.Mesh(2, 2, rank),
                                torch.from_numpy(images),
                                torch.from_numpy(labels))
        for t, want in zip(got, by_device):
            np.testing.assert_array_equal(t.numpy(), want[rank])


# --------------------------------------------------------------------------
# (b) the halo exchange
# --------------------------------------------------------------------------
@pytest.mark.parametrize("space,h", [(2, 8), (4, 8), (4, 4)])
def test_halo_h_is_the_zero_padded_global_window(ranks, space, h):
    rng = np.random.RandomState(5)
    cases = {}
    for sp, hh in ((2, 8), (4, 8), (4, 4)):  # the fixture's draws
        cases[sp, hh] = (rng.randn(2, 3, 2, hh, 5).astype(np.float32),
                         rng.randn(sp, 2, 3, 2, hh // sp + 4,
                                   5).astype(np.float32))
    x, g = (torch.from_numpy(a) for a in cases[space, h])
    per = h // space
    padded = torch.nn.functional.pad(x, (0, 0, 2, 2))
    xr = x.clone().requires_grad_(True)
    loss = 0
    for r, got in enumerate(ranks):
        s = r % space
        out = got["halo{}_{}".format(space, h)]
        want = padded[:, :, :, s * per:s * per + per + 4]
        assert torch.equal(out["plain"], want)
        if per >= 2:
            assert torch.equal(out["y"], want)
        if r < space:
            loss = loss + (torch.nn.functional.pad(xr, (0, 0, 2, 2))[
                :, :, :, s * per:s * per + per + 4] * g[s]).sum()
    if per < 2:  # a shard of fewer rows has no differentiable halo
        assert all("dx" not in got["halo{}_{}".format(space, h)]
                   for got in ranks)
        return
    loss.backward()
    dx = torch.cat([ranks[s]["halo{}_{}".format(space, h)]["dx"]
                    for s in range(space)], dim=3)
    torch.testing.assert_close(dx, xr.grad, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# (c) the conv5 op under a data 2 x space 2 mesh
# --------------------------------------------------------------------------
def _assemble(ranks, case, key):
    """Rank (d, s)'s kernel-layout blocks joined into the global tensor."""
    rows = [torch.cat([ranks[2 * d + s][case][key] for s in range(2)], 3)
            for d in range(2)]
    return torch.cat(rows, 0)


@pytest.mark.parametrize("kind", ["head", "stem"])
def test_sharded_conv5_matches_the_jax_mesh_program(ranks, kind):
    want = _jax_conv(kind)
    case = "conv5_" + kind
    to_kl = lambda a: _kl(a).numpy()  # noqa: E731
    np.testing.assert_allclose(_assemble(ranks, case, "y").numpy(),
                               to_kl(want["y"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_assemble(ranks, case, "yf").numpy(),
                               want["yf"], atol=1e-4, rtol=0)
    if kind == "head":
        np.testing.assert_allclose(_assemble(ranks, case, "dx").numpy(),
                                   to_kl(want["dx"]), atol=1e-4, rtol=0)
    for got in ranks:  # summed over the world: the same on every rank
        np.testing.assert_allclose(got[case]["dw"].numpy(), want["dw"],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(got[case]["db"].numpy(), want["db"],
                                   atol=2e-4, rtol=0)


# --------------------------------------------------------------------------
# (d), (e) one train step
# --------------------------------------------------------------------------
def _assert_like_the_single_process_step(ranks, deepsup):
    ref = _port_step(deepsup)
    case = "step_deepsup" if deepsup else "step_vnet"
    for got in ranks:
        got = got[case]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        torch.testing.assert_close(got["dice"], ref["dice"], rtol=1e-5,
                                   atol=1e-6)
    # every rank ends with rank 0's gradients, parameters and statistics
    assert max(got[case]["diff_to_rank0"] for got in ranks[1:]) <= 1e-6
    got = ranks[0][case]
    assert got["grads"].keys() == ref["grads"].keys()
    for k, v in ref["grads"].items():
        torch.testing.assert_close(got["grads"][k], v, rtol=0, atol=1e-5,
                                   msg=k)
    for k, v in ref["state"].items():  # parameters and statistics
        torch.testing.assert_close(got["state"][k].float(), v.float(),
                                   rtol=0, atol=1e-5, msg=k)


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def test_vnet_step_at_data_2_space_2_matches_jax_and_one_process(ranks):
    start, metrics, trace, after = _jax_vnet_step()
    p = _step_payload(False)
    model = VNet(**p["model"])
    for got in ranks:
        np.testing.assert_allclose(got["step_vnet"]["loss"],
                                   float(metrics["loss"]), rtol=2e-4)
    _assert_like_the_single_process_step(ranks, deepsup=False)
    got = ranks[0]["step_vnet"]  # the others hold the same
    for name, prm in model.named_parameters():
        prm.grad = got["grads"][name]
    jgrads = jax.tree_util.tree_map(lambda t, w: t - 1e-4 * w, trace,
                                    start["params"])
    ours = _leaves(transplant.grads_to_flax(model))
    theirs = _leaves(jgrads)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (name, a), (_, b) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=5e-3,
                                   err_msg=name)
    moved = transplant.flax_from_state_dict(got["state"])
    stats = _leaves(moved["batch_stats"])
    assert len(stats) == 2 * 24
    for (name, a), (_, b) in zip(stats, _leaves(after["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-3, rtol=2e-2,
                                   err_msg=name)


def test_vnet_deepsup_step_at_space_2_matches_one_process(ranks):
    """The spine geometry, (8, 32, 32) a sample, dropout on: the heads'
    1-row halos, the upsample's edge rows and the global batch's dropout
    masks give the single-process step."""
    _assert_like_the_single_process_step(ranks, deepsup=True)


# --------------------------------------------------------------------------
# (f) the loader's rows of the global order
# --------------------------------------------------------------------------
def test_loader_rows_are_the_jax_loaders_global_batches(tmp_path):
    phase0 = _write_dataset(str(tmp_path), (4, 8, 8), 5, 3)
    jds = JMedicalDataset(phase0, phase0, [JRandomFlip3D()], 3,
                          repeat_train=2)
    tds = MedicalDataset(phase0, phase0, [RandomFlip3D()], 3,
                         repeat_train=2)
    ref = jloader.TrainLoader(jds, batch_size=4, num_workers=1, seed=2,
                              mode="device", wire_dtype="float32")
    ours = [tloader.TrainLoader(tds, batch_size=4, num_workers=1, seed=2,
                                mode=mode, wire_dtype="float32", rows=rows)
            for mode in ("device", "device_cache")
            for rows in (tmesh.Mesh(2, 2, 0).rows(2),
                         tmesh.Mesh(2, 2, 2).rows(2), None)]
    try:
        for _ in range(4):  # across an epoch boundary (10 items)
            images, labels = next(ref)
            a, b, _, ia, ib, whole = (next(loader) for loader in ours)
            np.testing.assert_array_equal(
                torch.cat([a[0], b[0]]).numpy(), images)
            np.testing.assert_array_equal(
                torch.cat([a[1], b[1]]).numpy(), labels)
            np.testing.assert_array_equal(np.concatenate([ia, ib]), whole)
    finally:
        ref.stop()
        for loader in ours:
            loader.stop()


# --------------------------------------------------------------------------
# (g) evaluate
# --------------------------------------------------------------------------
@pytest.mark.parametrize("space", [1, 2])
def test_evaluate_over_the_mesh_matches_jax(ranks, eval_setup, space):
    want, jax_dir, _, _, tmp = eval_setup
    results = [got["evaluate_space{}".format(space)] for got in ranks]
    for result in results:
        assert result == results[0]  # every rank returns the same
        for key in ("mdice", "mdice_hard"):
            np.testing.assert_allclose(result[key], want[key], rtol=1e-4,
                                       err_msg=key)
    # rank 0 alone dumps: its share is volume 0
    out = tmp / "port{}".format(space)
    assert sorted(os.listdir(out)) == ["rank0"]
    assert sorted(os.listdir(out / "rank0")) == ["0"]
    np.testing.assert_array_equal(
        np.load(out / "rank0" / "0" / "pred.npy"),
        np.load(os.path.join(jax_dir, "0", "pred.npy")))


@pytest.mark.parametrize("mode", ["sw2", "auc"])
def test_evaluate_modes_over_the_mesh_match_one_process(ranks, eval_setup,
                                                        mode):
    """``sw_num`` over a data 2 x space 2 mesh shares the volumes over the
    data axis only (windows whole); AUC-ROC evaluates every volume on
    every rank. Both give the single-process result (test_torch_eval.py
    holds that one to the JAX evaluate), and rank 0 alone dumps."""
    _, _, yml, pt, tmp = eval_setup
    cfg = tconfig.Config(yml)
    model = cfg.model
    model.load_state_dict(torch.load(pt))
    from medicalseg_torch.core.state import TrainState
    from medicalseg_torch.core.val import evaluate
    kw = {"sw_num": 2} if mode == "sw2" else {"auc_roc": True}
    want = evaluate(TrainState(model, None, None, None), cfg.val_dataset,
                    cfg.loss, save_dir=str(tmp / (mode + "_one")),
                    print_detail=False, **kw)
    for got in ranks:
        result = got["evaluate_" + mode]
        assert result.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_allclose(result[key], value, rtol=1e-12,
                                       err_msg=key)
    dumped = sorted(os.listdir(tmp / mode / "rank0"))
    assert sorted(os.listdir(tmp / mode)) == ["rank0"]
    assert dumped == (["0"] if mode == "sw2" else ["0", "1"])
    for name in dumped:
        np.testing.assert_array_equal(
            np.load(tmp / mode / "rank0" / name / "pred.npy"),
            np.load(tmp / (mode + "_one") / name / "pred.npy"))


# --------------------------------------------------------------------------
# (h) the train CLI under torchrun
# --------------------------------------------------------------------------
def _run_cli(args, nproc=None, timeout=300):
    cmd = [sys.executable] + (
        ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(nproc)] if nproc else []) + ["-m", "medicalseg_torch.train"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(cmd + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return proc


def _checkpoint(path, step):
    model = tconfig.Config(path).model
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    assert tckpt.load_checkpoint(step, model, optimizer) == int(
        step.rsplit("_", 1)[1])
    return model.state_dict()


def test_train_cli_at_world_2_equals_one_process_and_resumes(tmp_path):
    """``--space 2`` over two ranks: two iterations from the loader's rows
    of the global order equal the single-process run at the same global
    batch; rank 0 alone logs, and a resume from its iter_2 over the two
    ranks as the data axis (``--space 1``: a global batch of two) runs on
    to iter_3."""
    phase0 = _write_dataset(str(tmp_path / "data"), (8, 32, 32), 3, 20)
    path = _spine_yaml(tmp_path, phase0)
    common = ["--config", path, "--iters", "2", "--save_interval", "2",
              "--log_iters", "1", "--seed", "0", "--device", "cpu"]
    world = _run_cli(common + ["--space", "2", "--save_dir",
                               str(tmp_path / "w2")], nproc=2)
    assert "over gloo" in world.stdout
    lines = [ln for ln in world.stdout.splitlines() if "[TRAIN]" in ln]
    assert len(lines) == 2 and "iter: 2/2" in lines[-1]
    _run_cli(common + ["--save_dir", str(tmp_path / "one")])
    resumed = _run_cli(common[:3] + ["3"] + common[4:] + [
        "--space", "1", "--save_dir", str(tmp_path / "re"),
        "--resume_model", str(tmp_path / "w2" / "iter_2")], nproc=2)
    assert "data 2 x space 1 (gloo), global batch 2" in resumed.stdout
    lines = [ln for ln in resumed.stdout.splitlines() if "[TRAIN]" in ln]
    assert len(lines) == 1 and "iter: 3/3" in lines[0]
    assert sorted(os.listdir(tmp_path / "re")) == ["iter_3"]
    assert sorted(os.listdir(tmp_path / "re" / "iter_3")) == [
        "model.msgpack", "opt.msgpack"]
    want = _checkpoint(path, str(tmp_path / "one" / "iter_2"))
    got = _checkpoint(path, str(tmp_path / "w2" / "iter_2"))
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-5, msg=k)
