"""The port's VNetDeepSup against the JAX package's at the geometry of the
upstream recipe configs/mri_spine_seg/vnetdeepsup_mri_spine_seg_512_512_12_15k.yml
(float32, 20 classes, VALID down convs ``kernel_size [[2,2,4], ...]`` /
``stride_size [[2,2,1], ...]``, the default XLA convs on the JAX side), cut
to (1, 32, 32, 12, 1): W runs 12 -> 9 -> 8 -> 4 -> 2, so the heads sit at
(4, 4, 4), (8, 8, 8) and (16, 16, 9) and are upsampled back to W = 12 from
ragged W. Weights move by medicalseg_torch.utils.transplant; inputs come
from numpy RandomState and go through both.

Also the YAML through the port's ``Config``, and the main output
(``VNet.main_output``): equal to ``forward(x)[0]`` bit for bit, with no
deep-supervision head run, through each eval and serving consumer
(``core.infer.inference``, ``core.val`` whole and space-sharded,
``core.sliding_window``, the export wrapper and its program,
``deploy.infer.Predictor`` plain and int8).

Tolerances are tests/test_torch_vnet_deepsup.py's: the four eval outputs
at atol 2e-4 / rtol 1e-3; one train step's loss at rtol 2e-4 and every
leaf's gradient (the heads' among them) at atol 5e-4 / rtol 5e-3. The two
packages draw dropout masks from different generators, so the step feeds
both the same masks, drawn with numpy. The losses are the YAML's four
MixedLoss heads in their default (fused) form on both sides.
"""
import functools
import os

import numpy as np
import pytest
import yaml

import flax
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.models import VNetDeepSup as JVNetDeepSup
from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.utils import loss_utils as jlu
from medicalseg_torch import export
from medicalseg_torch.core import infer as tinfer
from medicalseg_torch.core import sliding_window as tsw
from medicalseg_torch.core import val as tval
from medicalseg_torch.cvlibs.config import Config
from medicalseg_torch.datasets import MRISpineSeg
from medicalseg_torch.deploy import infer as tdeploy
from medicalseg_torch.models import VNetDeepSup
from medicalseg_torch.models import layers as tl
from medicalseg_torch.models.vnet_deepsup import ConvHead
from medicalseg_torch.ops import resize as tresize
from medicalseg_torch.parallel.mesh import Mesh
from medicalseg_torch.utils import loss_utils as tlu
from medicalseg_torch.utils import transplant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "mri_spine_seg",
                      "vnetdeepsup_mri_spine_seg_512_512_12_15k.yml")
KS = ((2, 2, 4), (2, 2, 2), (2, 2, 2), (2, 2, 2))
SS = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2))
SHAPE = (1, 32, 32, 12, 1)
N_CLASSES = 20
HEADS = ("Conv_0", "Conv_1", "Conv_2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX model at the recipe's geometry, its variables (non-trivial
    BN statistics) and an input."""
    rng = np.random.RandomState(0)
    x = rng.rand(*SHAPE).astype(np.float32)
    model = JVNetDeepSup(in_channels=1, num_classes=N_CLASSES,
                         kernel_size=KS, stride_size=SS)
    variables = jax.jit(lambda k, a: model.init(k, a, train=False))(
        jax.random.PRNGKey(42), jnp.asarray(x))
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    variables = {"params": jax.device_get(flax.core.unfreeze(
        variables["params"])), "batch_stats": stats}
    return model, x, variables


def _port_model(variables=None):
    model = VNetDeepSup(num_classes=N_CLASSES, kernel_size=KS,
                        stride_size=SS)
    if variables is None:
        variables = _jax_model()[2]
    model.load_state_dict(transplant.state_dict_from_flax(variables))
    return model


class _HeadCalls:
    """Counts the forwards of a model's deep-supervision heads (a forward
    hook on each ``ConvHead``)."""

    def __init__(self, model):
        self.count = 0
        self._handles = [m.register_forward_hook(self._hook)
                         for m in model.modules() if isinstance(m, ConvHead)]
        assert len(self._handles) == 3

    def _hook(self, *_):
        self.count += 1

    def remove(self):
        for h in self._handles:
            h.remove()


def test_the_heads_sit_at_ragged_w():
    shapes = {}
    model = _port_model().eval()

    def hook(name):
        def record(module, inputs, output):
            shapes[name] = tuple(output.shape)
        return record

    hooks = [getattr(model, name).register_forward_hook(hook(name))
             for name in HEADS]
    with torch.no_grad():
        model(torch.zeros(SHAPE))
    for h in hooks:
        h.remove()
    assert shapes == {"Conv_0": (1, 4, 4, 4, N_CLASSES),
                      "Conv_1": (1, 8, 8, 8, N_CLASSES),
                      "Conv_2": (1, 16, 16, 9, N_CLASSES)}


def test_eval_outputs_match_jax():
    model, x, variables = _jax_model()
    ref = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    port = _port_model().eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert g.shape == r.shape == SHAPE[:4] + (N_CLASSES,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=1e-3)


class _FixedMasks:
    """Stands in for ``jax.random`` inside flax's Dropout: ``bernoulli``
    returns the next of the given keep masks [N, C], shaped as asked."""

    def __init__(self, masks):
        self.masks = list(masks)

    def bernoulli(self, key, p, shape):
        keep = self.masks.pop(0)
        assert keep.shape[0] == shape[0] and keep.shape[1] in shape[1:]
        return jnp.asarray(keep.reshape(shape))


def _masks(rng):
    """Keep masks [N, C] of the six ChannelDropouts of a train forward, in
    call order: down_tr128, down_tr256, then up_tr256 and up_tr128 (their
    input, then their skip)."""
    return [(rng.rand(SHAPE[0], c) >= 0.5)
            for c in (128, 256, 256, 128, 256, 64)]


def _port_dropout_from(masks):
    masks = list(masks)

    def forward(self, xk):
        keep = masks.pop(0)
        keep = torch.from_numpy(keep).reshape(keep.shape[0], 1,
                                              keep.shape[1], 1, 1)
        return xk * (keep.to(xk.dtype) / (1.0 - self.RATE))

    return forward


def _jax_losses():
    mixed = [jlosses.MixedLoss([jlosses.CrossEntropyLoss(),
                                jlosses.DiceLoss()], [1.0, 1.0])
             for _ in range(4)]
    return {"types": mixed, "coef": [0.25] * 4}


@functools.lru_cache(maxsize=None)
def _jax_step():
    """One JAX train step on a seeded batch with the masks it was fed:
    (labels, masks, loss, grads)."""
    model, x, variables = _jax_model()
    rng = np.random.RandomState(5)
    labels = rng.randint(0, N_CLASSES, SHAPE[:4]).astype(np.int32)
    masks = _masks(rng)
    losses = _jax_losses()

    def loss_fn(params):
        outs, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        loss_list, _ = jlu.loss_computation(outs, jnp.asarray(labels),
                                            losses)
        return sum(loss_list)

    with pytest.MonkeyPatch.context() as m:
        m.setenv("MEDSEG_LOSS_FUSED", "1")
        m.setattr(flax_stochastic, "random", _FixedMasks(masks))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"])
    return labels, masks, float(loss), jax.device_get(grads)


def test_train_step_with_the_recipe_losses_matches_jax(monkeypatch):
    """One train step (batch statistics, dropout, the YAML's four
    MixedLoss heads built by the port's ``Config``): the summed loss and
    every parameter's gradient, ``Conv_0..2`` among them."""
    _, x, _ = _jax_model()
    labels, masks, jloss, jgrads = _jax_step()
    port = _port_model().train()
    monkeypatch.setenv("MEDSEG_LOSS_FUSED", "1")
    monkeypatch.setattr(tl.ChannelDropout, "forward",
                        _port_dropout_from(masks))
    outs = port(torch.from_numpy(x))
    assert [tuple(o.shape) for o in outs] == [SHAPE[:4] + (N_CLASSES,)] * 4
    loss_list, _ = tlu.loss_computation(
        outs, torch.from_numpy(labels).long(), Config(RECIPE).loss)
    loss = sum(loss_list)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=2e-4)

    got = transplant.grads_to_flax(port)
    assert (jax.tree_util.tree_structure(got) ==
            jax.tree_util.tree_structure(jgrads))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=5e-3,
                                   err_msg=jax.tree_util.keystr(path))
    for name in HEADS:
        assert np.abs(got[name]["kernel"]).sum() > 0


def test_config_builds_the_upstream_recipe():
    cfg = Config(RECIPE)
    mc = cfg.dic["model"]
    assert mc["type"] == "VNetDeepSup" and mc["num_classes"] == N_CLASSES
    assert not {"dtype", "remat", "head_conv", "mid_conv"} & set(mc)
    model = cfg.model
    assert isinstance(model, VNetDeepSup)
    assert model.dtype == torch.float32 and not model.remat
    assert model.down_tr32.down_conv.weight.shape[2:] == (2, 2, 4)
    assert model.down_tr32.down_conv.stride == (2, 2, 1)
    assert model.down_tr64.down_conv.stride == (2, 2, 1)
    assert model.Conv_2.weight.shape == (N_CLASSES, 64, 3, 3, 3)
    losses = cfg.loss
    assert len(losses["types"]) == 4 and losses["coef"] == [0.25] * 4
    for t in losses["types"]:
        assert type(t).__name__ == "MixedLoss" and t.coef == [1, 1]
        assert [type(x).__name__ for x in t.losses] == [
            "CrossEntropyLoss", "DiceLoss"]
    opt = cfg.build_optimizer(model.parameters())
    assert isinstance(opt, torch.optim.SGD)
    assert opt.defaults["momentum"] == 0.9
    assert opt.defaults["weight_decay"] == pytest.approx(1e-4)
    assert cfg.batch_size == 3 and cfg.iters == 15000
    assert cfg.lr_scheduler(0) == pytest.approx(0.1)
    assert cfg.lr_scheduler(7500) == pytest.approx(0.1 * 0.5 ** 0.9)
    assert cfg.lr_scheduler(15000) == pytest.approx(0.0)


@functools.lru_cache(maxsize=None)
def _eval_model():
    """The transplanted model at eval, an input and ``forward(x)[0]``."""
    model = _port_model().eval()
    x = torch.from_numpy(_jax_model()[1])
    with torch.inference_mode():
        want = model(x)[0]
    return model, x, want


@pytest.fixture
def heads():
    model = _eval_model()[0]
    calls = _HeadCalls(model)
    yield calls
    calls.remove()


def test_main_output_is_the_first_output_bit_for_bit(heads):
    model, x, want = _eval_model()
    with torch.inference_mode():
        got = model.main_output(x)
        assert heads.count == 0
        assert torch.equal(got, want)
    assert heads.count == 0


def test_inference_takes_the_main_output(heads):
    model, x, want = _eval_model()
    pred, logit = tinfer.inference(model.main_output, x)
    assert heads.count == 0
    assert torch.equal(logit, want)
    assert torch.equal(pred, want.argmax(-1).to(torch.int32))


def test_space_sharded_eval_forward_takes_the_main_output(heads):
    """The space-sharded forward (``core.val._SpaceSharded``) of a
    one-process mesh: its block through the main output, gathered."""
    model, x, want = _eval_model()
    forward = tval._SpaceSharded(model, Mesh(1))
    _, logit = tinfer.inference(forward.main_output, x)
    assert heads.count == 0
    assert torch.equal(logit, want)


def test_sliding_window_takes_the_main_output(heads):
    """Three windows along D and two along W (the smallest W whose VALID
    down convs keep a voxel, 8 -> 5 -> 4 -> 2 -> 1): the blend through the
    main output equals the blend through the four-output forward's first
    entry."""
    model, x, _ = _eval_model()
    roi = (16, 32, 8)
    got = tsw.sliding_window_inference_batched(model.main_output, x, roi,
                                               N_CLASSES, window_batch=3)
    assert heads.count == 0
    want = tsw.sliding_window_inference_batched(lambda w: model(w)[0], x,
                                                roi, N_CLASSES,
                                                window_batch=3)
    assert heads.count == 3 * 2  # the reference's two forwards
    assert torch.equal(got, want)


def test_a_train_step_after_a_four_output_eval_call():
    """The heads' cached upsample matrices made by a first call under
    ``torch.inference_mode()`` (the four-output forward at eval) serve a
    later train step's backward: the matrices are built outside inference
    mode. Sizes that no other test of the process upsamples to, so that
    the first call makes them."""
    x = torch.randn(1, 3, 5, 7, 2)
    with torch.inference_mode():
        ref = tresize.upsample_trilinear_batch(x, (5, 11, 13))
    xg = x.clone().requires_grad_()
    y = tresize.upsample_trilinear_batch(xg, (5, 11, 13))
    y.sum().backward()
    assert torch.equal(y.detach(), ref) and xg.grad is not None


def _write_upstream_volume(root, x):
    """One volume in MRISpineSeg's phase0 layout (``images/``,
    ``labels/``, ``val_list.txt``), [D, H, W] as the upstream recipe's
    [512, 512, 12] volumes lie."""
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub))
    np.save(os.path.join(root, "images", "s0.npy"), x[0, ..., 0])
    label = np.random.RandomState(3).randint(0, N_CLASSES, x.shape[1:4])
    np.save(os.path.join(root, "labels", "s0.npy"), label.astype(np.uint8))
    with open(os.path.join(root, "val_list.txt"), "w") as f:
        f.write("images/s0.npy labels/s0.npy\n")


def test_evaluate_takes_the_main_output(heads, tmp_path):
    """``core.val.evaluate`` on an MRISpineSeg volume in the upstream
    layout: no head runs, and the dumped prediction is the argmax of
    ``forward(x)[0]``. (``sw_num`` 2 would cut W to 6, which the recipe's
    VALID down convs empty; its path is the sliding window's, above.)"""
    model, x, want = _eval_model()
    root = str(tmp_path / "phase0")
    _write_upstream_volume(root, x.numpy())
    dataset = MRISpineSeg(dataset_root=root, result_dir=str(tmp_path),
                          mode="val", num_classes=N_CLASSES)
    state = type("State", (), {"model": model, "step": 0})()
    out = str(tmp_path / "eval")
    result = tval.evaluate(state, dataset, Config(RECIPE).loss,
                           print_detail=False, save_dir=out)
    assert heads.count == 0 and np.isfinite(result["mdice"])
    pred = np.load(os.path.join(out, "0", "pred.npy"))
    np.testing.assert_array_equal(pred, want[0].argmax(-1).numpy())


def test_export_holds_no_head(heads, tmp_path):
    """The export wrapper's forward is ``forward(x)[0]`` bit for bit; its
    program holds no 3^3 conv (the heads') and none of the heads'
    parameters, and serves the same logits."""
    model, x, want = _eval_model()
    net = export.SavedSegmentationNet(model, with_argmax=False)
    with torch.no_grad():
        assert torch.equal(net(x), want)
        program = export.export_program(net, x, str(tmp_path / "m.pt2"))
    assert heads.count == 0
    kernels = [tuple(n.args[1].meta["val"].shape[2:])
               for n in program.graph.nodes if n.op == "call_function"
               and "conv" in str(n.target)
               and not str(n.target).startswith("medicalseg.")]
    assert len(kernels) == 8 and (3, 3, 3) not in kernels  # up/down convs
    # the heads' parameters are lifted as inputs, and nothing reads them
    lifted = program.graph_signature.inputs_to_parameters
    unread = [lifted[n.name] for n in program.graph.nodes
              if n.op == "placeholder" and n.name in lifted and not n.users]
    assert sorted(unread) == sorted("net.{}.{}".format(h, k) for h in HEADS
                                    for k in ("weight", "bias"))
    loaded = torch.export.load(str(tmp_path / "m.pt2")).module()
    with torch.no_grad():
        np.testing.assert_allclose(loaded(x).numpy(), want.numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_predictor_takes_the_main_output(tmp_path, precision):
    """``deploy.infer.Predictor`` on the rebuilt module (``--precision
    fp32``: ``forward(x)[0]`` bit for bit) and with int8 weights (the
    dequantized state through the main output: the four-output forward's
    first entry on the same state, bit for bit); no head runs."""
    model, x, want = _eval_model()
    torch.save(model.state_dict(), str(tmp_path / "model.pt"))
    mc = dict(Config(RECIPE).dic["model"])
    with open(str(tmp_path / "deploy.yaml"), "w") as f:
        yaml.safe_dump({"Deploy": {
            "model": "model.stablehlo", "params": "model.pt",
            "transforms": [], "output_op": "none",
            "input_shape_ndhwc": list(SHAPE), "model_config": mc}}, f)
    pred = tdeploy.Predictor(tdeploy.parse_args([
        "--config", str(tmp_path / "deploy.yaml"), "--image_path", "unused",
        "--save_dir", str(tmp_path / "out"), "--device", "cpu",
        "--precision", precision]))
    calls = _HeadCalls(pred.model)
    try:
        got = pred._forward(x.numpy())
        assert calls.count == 0
        if precision == "int8":
            state = tdeploy.quant.dequantize_state_dict(
                pred._qstate, pred._transposed)
            with torch.inference_mode():
                want = torch.func.functional_call(pred.model, state,
                                                  (x,))[0]
            assert calls.count == 3
        np.testing.assert_array_equal(got, want.numpy())
    finally:
        calls.remove()
