"""The port's VNetDeepSup (medicalseg_torch.models.vnet_deepsup) against
the JAX package's, with weights moved by medicalseg_torch.utils.transplant,
at the spine geometry of configs/synthetic/vnetdeepsup_synspine_15k.yml
(per-stage kernels and strides, ``head_conv`` / ``mid_conv`` 'pallas') cut
to (1, 8, 32, 32, 1): D >= 8, below which the spine strides leave a stage
empty. Also the half-pixel upsample of the heads against the JAX one, the
transplant of the heads both ways, and the flagship YAML through the
port's ``Config``.

Inputs come from numpy RandomState and go through both; float32
throughout. Tolerances: the four outputs at the 2e-4 / 1e-3 of
tests/test_torch_vnet.py (16 convs of up to 125 * 256 products each,
summed in another order); the loss of one train step at rtol 2e-4 and its
gradients at atol 5e-4 / rtol 5e-3 at every leaf, as
tests/test_torch_train.py holds the VNet step; the upsample at 1e-6 (one
2-tap matrix per axis). The JAX losses run in their loop form
(``MEDSEG_LOSS_FUSED=0``), and in their fused form against the flagship
YAML's losses built by the port's ``Config``. The two packages
draw dropout masks from different generators, so the train step feeds
both the same masks, drawn with numpy.
"""
import functools
import os

import numpy as np
import pytest

import flax
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.models import VNetDeepSup as JVNetDeepSup
from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.ops import resize as jresize
from medicalseg_tpu.utils import loss_utils as jlu
from medicalseg_torch.cvlibs.config import Config
from medicalseg_torch.models import VNetDeepSup
from medicalseg_torch.models import layers as tl
from medicalseg_torch.models import losses as tlosses
from medicalseg_torch.ops import resize as tresize
from medicalseg_torch.utils import loss_utils as tlu
from medicalseg_torch.utils import transplant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "synthetic",
                        "vnetdeepsup_synspine_15k.yml")
SPINE_KS = ((4, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))
SPINE_SS = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2))
SHAPE = (1, 8, 32, 32, 1)
N_CLASSES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX model at the spine geometry, its variables (non-trivial BN
    statistics, as tests/test_torch_vnet.py sets them) and an input."""
    rng = np.random.RandomState(0)
    x = rng.rand(*SHAPE).astype(np.float32)
    model = JVNetDeepSup(in_channels=1, num_classes=N_CLASSES,
                         kernel_size=SPINE_KS, stride_size=SPINE_SS,
                         head_conv="pallas", mid_conv="pallas")
    variables = jax.jit(lambda k, a: model.init(k, a, train=False))(
        jax.random.PRNGKey(42), jnp.asarray(x))
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    variables = {"params": jax.device_get(flax.core.unfreeze(
        variables["params"])), "batch_stats": stats}
    return model, x, variables


def _port_model(variables, remat=False):
    model = VNetDeepSup(num_classes=N_CLASSES, kernel_size=SPINE_KS,
                        stride_size=SPINE_SS, remat=remat)
    model.load_state_dict(transplant.state_dict_from_flax(variables))
    return model


def test_eval_outputs_match_jax():
    model, x, variables = _jax_model()
    ref = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    port = _port_model(variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert r.shape == SHAPE[:4] + (N_CLASSES,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=1e-3)


class _FixedMasks:
    """Stands in for ``jax.random`` inside flax's Dropout: ``bernoulli``
    returns the next of the given keep masks [N, C], shaped as asked (the
    channel on the one axis of the broadcast shape that is neither the
    batch nor 1)."""

    def __init__(self, masks):
        self.masks = list(masks)

    def bernoulli(self, key, p, shape):
        keep = self.masks.pop(0)
        assert keep.shape[0] == shape[0] and keep.shape[1] in shape[1:]
        return jnp.asarray(keep.reshape(shape))


def _masks(rng):
    """Keep masks of the six ChannelDropouts of a train forward, in call
    order: down_tr128, down_tr256, then up_tr256 and up_tr128 (their input,
    then their skip), each [N, C]."""
    chans = (128, 256, 256, 128, 256, 64)
    return [(rng.rand(SHAPE[0], c) >= 0.5) for c in chans]


def _port_dropout_from(masks):
    """The port's ChannelDropout.forward with the given masks in call
    order (a recomputed forward reuses its mask, as the module does)."""
    masks = list(masks)

    def forward(self, xk):
        if not tl._RECOMPUTING or self._keep is None:
            keep = masks.pop(0)
            self._keep = torch.from_numpy(keep).reshape(
                keep.shape[0], 1, keep.shape[1], 1, 1)
        return xk * (self._keep.to(xk.dtype) / (1.0 - self.RATE))

    return forward


def _losses(module):
    mixed = [module.MixedLoss([module.CrossEntropyLoss(), module.DiceLoss()],
                              [1.0, 1.0]) for _ in range(4)]
    return {"types": mixed, "coef": [0.25] * 4}


@functools.lru_cache(maxsize=None)
def _jax_step(fused="0"):
    """One JAX train step's loss, gradients and BN statistics on a seeded
    batch, with the dropout masks it was fed: (labels, masks, loss,
    batch_stats, grads). ``fused`` is the losses' ``MEDSEG_LOSS_FUSED``."""
    model, x, variables = _jax_model()
    rng = np.random.RandomState(5)
    labels = rng.randint(0, N_CLASSES, SHAPE[:4]).astype(np.int32)
    masks = _masks(rng)
    jl = _losses(jlosses)

    def loss_fn(params):
        outs, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(
                1)}, mutable=["batch_stats"])
        loss_list, _ = jlu.loss_computation(outs, jnp.asarray(labels), jl)
        return sum(loss_list), upd["batch_stats"]

    with pytest.MonkeyPatch.context() as m:
        m.setenv("MEDSEG_LOSS_FUSED", fused)
        m.setattr(flax_stochastic, "random", _FixedMasks(masks))
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    return labels, masks, float(loss), jax.device_get(stats), \
        jax.device_get(grads)


def _assert_step_matches_jax(monkeypatch, losses, remat=False, fused="0"):
    """One port train step with ``losses`` against :func:`_jax_step`: the
    summed loss, every parameter's gradient, and the BN statistics it
    leaves."""
    _, x, variables = _jax_model()
    labels, masks, jloss, jstats, jgrads = _jax_step(fused)
    port = _port_model(variables, remat=remat).train()
    monkeypatch.setattr(tl.ChannelDropout, "forward",
                        _port_dropout_from(masks))
    outs = port(torch.from_numpy(x))
    loss_list, _ = tlu.loss_computation(
        outs, torch.from_numpy(labels).long(), losses)
    loss = sum(loss_list)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=2e-4)

    got = transplant.grads_to_flax(port)
    want = jgrads
    assert (jax.tree_util.tree_structure(got) ==
            jax.tree_util.tree_structure(want))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=5e-3,
                                   err_msg=jax.tree_util.keystr(path))
    for name in ("Conv_0", "Conv_1", "Conv_2"):
        assert np.abs(got[name]["kernel"]).sum() > 0
    moved = transplant.flax_from_state_dict(port.state_dict())["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(moved),
                    jax.tree_util.tree_leaves(jstats)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_loss_and_gradients_match_jax(monkeypatch, remat):
    """One train step (batch statistics, dropout, the 4-way MixedLoss of
    the flagship config): the summed loss, every parameter's gradient, and
    the BN statistics it leaves."""
    _assert_step_matches_jax(monkeypatch, _losses(tlosses), remat=remat)


def test_train_step_with_the_flagship_config_losses_in_the_fused_form(
        monkeypatch):
    """The same step with the flagship YAML's four MixedLoss heads built
    by the port's ``Config``, in the losses' default (fused) form, against
    the JAX step in its fused form."""
    monkeypatch.setenv("MEDSEG_LOSS_FUSED", "1")
    _assert_step_matches_jax(monkeypatch, Config(FLAGSHIP).loss, fused="1")


def test_transplant_round_trips_with_the_heads():
    _, _, variables = _jax_model()
    sd = transplant.state_dict_from_flax(variables)
    for name in ("Conv_0", "Conv_1", "Conv_2"):
        kernel = variables["params"][name]["kernel"]
        assert kernel.shape[:3] == (3, 3, 3)
        np.testing.assert_array_equal(
            sd[name + ".weight"].numpy(),
            np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))
    port = VNetDeepSup(num_classes=N_CLASSES, kernel_size=SPINE_KS,
                       stride_size=SPINE_SS)
    assert list(sd) == list(port.state_dict())
    back = transplant.flax_from_state_dict(sd)
    assert (jax.tree_util.tree_structure(back) ==
            jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_seeded_heads_are_he_normal_with_zero_bias():
    a = VNetDeepSup(num_classes=20, generator=torch.Generator().manual_seed(3))
    b = VNetDeepSup(num_classes=20, generator=torch.Generator().manual_seed(3))
    for name, ci in (("Conv_0", 256), ("Conv_1", 128), ("Conv_2", 64)):
        w = getattr(a, name).weight
        assert w.shape == (20, ci, 3, 3, 3)
        assert torch.equal(w, getattr(b, name).weight)
        assert not getattr(a, name).bias.any()
        assert abs(w.std().item() / np.sqrt(2.0 / (27 * ci)) - 1) < 0.05


@pytest.mark.parametrize("src,dst", [
    ((2, 3, 4), (2, 3, 4)),      # identity
    ((1, 5, 2), (3, 5, 7)),      # one-voxel axis, unchanged axis
    ((4, 8, 8), (12, 64, 64)),   # the flagship's d1: 3x along D, 8x in-plane
    ((9, 16, 16), (12, 32, 32)),  # non-integer D ratio (d3's 9 -> 12)
    ((3, 5, 7), (8, 11, 20))])   # anisotropic, odd ratios everywhere
def test_upsample_matches_jax_at_borders_and_anisotropic_sizes(src, dst):
    rng = np.random.RandomState(sum(src))
    x = rng.randn(2, *src, 3).astype(np.float32)
    ref = np.asarray(jresize.upsample_trilinear_batch(jnp.asarray(x), dst))
    got = tresize.upsample_trilinear_batch(torch.from_numpy(x), dst)
    assert tuple(got.shape) == (2, *dst, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    # the first and last outputs of each axis are the inputs' edges
    if src[2] < dst[2] and src[:2] == dst[:2]:
        np.testing.assert_allclose(got.numpy()[..., 0, :], x[..., 0, :],
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy()[..., -1, :], x[..., -1, :],
                                   atol=1e-6)


def test_upsample_matrix_matches_jax_and_raises_on_a_downscale():
    for n_in, n_out in ((1, 4), (3, 3), (4, 12), (9, 12), (5, 17)):
        np.testing.assert_allclose(
            tresize._linear_matrix_halfpixel(n_in, n_out).numpy(),
            np.asarray(jresize._linear_matrix_halfpixel(n_in, n_out)),
            atol=1e-7)
    with pytest.raises(ValueError, match="only upsamples"):
        tresize.upsample_trilinear_batch(torch.zeros(1, 4, 4, 4, 1),
                                         (4, 2, 8))


def test_upsample_keeps_bf16_and_is_differentiable():
    x = torch.randn(1, 2, 3, 4, 2, dtype=torch.bfloat16, requires_grad=True)
    y = tresize.upsample_trilinear_batch(x, (4, 6, 8))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


def test_config_builds_the_flagship_model():
    cfg = Config(FLAGSHIP)
    model = cfg.model
    assert isinstance(model, VNetDeepSup)
    assert model.dtype == torch.bfloat16 and model.remat
    assert model.out_tr.conv2.weight.shape[0] == 20
    assert model.Conv_0.weight.shape == (20, 256, 3, 3, 3)
    assert model.down_tr32.down_conv.weight.shape[2:] == (4, 2, 2)
    assert model.down_tr32.down_conv.stride == (1, 2, 2)
    losses = cfg.loss
    assert len(losses["types"]) == 4 and losses["coef"] == [0.25] * 4
    assert all(type(t).__name__ == "MixedLoss" for t in losses["types"])
    opt = cfg.build_optimizer(model.parameters())
    assert isinstance(opt, torch.optim.SGD)
    assert opt.defaults["momentum"] == 0.9
    assert cfg.batch_size == 3
    assert cfg.lr_scheduler(0) == pytest.approx(0.01)
