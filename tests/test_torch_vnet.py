"""The port's layers and VNet (medicalseg_torch.models) against the JAX
package's flax modules, with weights moved by
medicalseg_torch.utils.transplant. Inputs come from numpy RandomState and
go through both; float32 throughout. Tolerances: 1e-5 for single layers,
and for the whole net the 2e-4 / 1e-3 of tests/test_vnet_torch_parity.py
(16 convs of up to 125 * 256 products each, summed in another order).
"""
import functools

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.models import VNet as JVNet
from medicalseg_tpu.models import layers as jl
from medicalseg_torch.models import VNet
from medicalseg_torch.models import layers as tl
from medicalseg_torch.utils import flax_from_state_dict, state_dict_from_flax

SPINE_KS = ((4, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))
SPINE_SS = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2))
RECIPE_KS = ((2, 2, 4), (2, 2, 2), (2, 2, 2), (2, 2, 2))
RECIPE_SS = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2))
GEOMETRIES = {
    "cube": dict(shape=(1, 16, 16, 16, 1)),
    "cube_pallas": dict(shape=(1, 16, 16, 16, 1), head_conv="pallas",
                        mid_conv="pallas"),
    # configs/synthetic/vnetdeepsup_synspine_15k.yml's per-stage
    # kernels/strides; W = 32 makes the first stages Pallas-eligible
    "spine_pallas": dict(shape=(1, 8, 32, 32, 1), kernel_size=SPINE_KS,
                         stride_size=SPINE_SS, head_conv="pallas",
                         mid_conv="pallas"),
    # the upstream spine recipe as its bf16 config runs it
    # (configs/mri_spine_seg/vnet_mri_spine_seg_512_512_12_15k_tpu.yml):
    # VALID down convs over W, so W runs 12 -> 9 -> 8 -> 4 -> 2
    "spine_recipe_bf16": dict(shape=(2, 32, 32, 12, 1),
                              kernel_size=RECIPE_KS, stride_size=RECIPE_SS,
                              head_conv="pallas", mid_conv="pallas",
                              dtype=jnp.bfloat16),
}
# bf16 logits of two frameworks round at other places through 31 layers:
# the package's bf16 tolerance (5e-3, tests/test_pallas_conv5.py's bound
# for one conv) holds as the mean absolute difference over the volume, the
# argmax as the serving bound (99.5% of voxels), and each logit within
# four bf16 ulps of the logits' magnitude (1-2): 2^-5. Measured: mean
# 1.55e-3, argmax 99.70%, worst 0.0273.
BF16_MEAN_ABS, BF16_ARGMAX, BF16_MAX_ABS = 5e-3, 0.995, 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _randomize_stats(variables, rng):
    """Non-trivial BN statistics, as test_vnet_torch_parity.py sets them."""
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    return {"params": jax.device_get(flax.core.unfreeze(variables["params"])),
            "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def _jax_vnet(name, dropout=True):
    g = dict(GEOMETRIES[name])
    shape = g.pop("shape")
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    model = JVNet(in_channels=1, num_classes=3, dropout=dropout, **g)
    variables = jax.jit(lambda k, a: model.init(k, a, train=False))(
        jax.random.PRNGKey(42), jnp.asarray(x))
    return model, x, _randomize_stats(variables, rng)


def _port_vnet(name, variables, dropout=True):
    g = {k: v for k, v in GEOMETRIES[name].items()
         if k in ("kernel_size", "stride_size")}
    if GEOMETRIES[name].get("dtype") == jnp.bfloat16:
        g["dtype"] = torch.bfloat16
    model = VNet(num_classes=3, dropout=dropout, **g)
    model.load_state_dict(state_dict_from_flax(variables))
    return model


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_vnet_eval_matches_jax(name):
    model, x, variables = _jax_vnet(name)
    ref = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x))[0])
    port = _port_vnet(name, variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))[0]
    assert got.shape == ref.shape
    if GEOMETRIES[name].get("dtype") == jnp.bfloat16:
        got, ref = got.float().numpy(), ref.astype(np.float32)
        diff = np.abs(got - ref)
        assert diff.mean() <= BF16_MEAN_ABS
        assert diff.max() <= BF16_MAX_ABS
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= BF16_ARGMAX
        return
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_vnet_train_forward_and_stats_match_jax():
    model, x, variables = _jax_vnet("cube", dropout=False)
    ref, upd = model.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    port = _port_vnet("cube", variables, dropout=False).train()
    got = port(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref[0]),
                               atol=2e-4, rtol=1e-3)
    moved = flax_from_state_dict(port.state_dict())["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(moved),
                    jax.tree_util.tree_leaves(upd["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)


def test_state_dict_round_trip_is_exact():
    _, _, variables = _jax_vnet("spine_pallas")
    back = flax_from_state_dict(state_dict_from_flax(variables))
    assert (jax.tree_util.tree_structure(back) ==
            jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_elu_vnet_round_trips_without_prelu():
    port = VNet(elu=True, num_classes=2)
    sd = port.state_dict()
    assert not any(k.endswith(".alpha") for k in sd)
    back = state_dict_from_flax(flax_from_state_dict(sd))
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_seeded_init_is_deterministic_and_he_scaled():
    a = VNet(num_classes=3, generator=torch.Generator().manual_seed(7))
    b = VNet(num_classes=3, generator=torch.Generator().manual_seed(7))
    c = VNet(num_classes=3, generator=torch.Generator().manual_seed(8))
    w = a.up_tr32.ops[0].conv1.weight
    assert torch.equal(w, b.up_tr32.ops[0].conv1.weight)
    assert not torch.equal(w, c.up_tr32.ops[0].conv1.weight)
    fan_in = 125 * 32
    assert abs(w.std().item() / np.sqrt(2.0 / fan_in) - 1) < 0.05
    bound = 2 * np.sqrt(2.0 / fan_in) / .8796  # truncation at 2 std
    assert float(w.detach().abs().max()) <= bound + 1e-6


def _bn_pair(rng, c):
    jbn = jl.BatchNorm3D(channel_axis=2)
    x = (2 * rng.randn(2, 3, c, 4, 5) + 1).astype(np.float32)
    v = flax.core.unfreeze(jbn.init(jax.random.PRNGKey(0), x, train=False))
    v["params"] = {"scale": rng.rand(c).astype(np.float32) + 0.5,
                   "bias": rng.randn(c).astype(np.float32)}
    v["batch_stats"] = {"mean": rng.randn(c).astype(np.float32),
                        "var": rng.rand(c).astype(np.float32) + 0.5}
    bn = tl.BatchNorm3D(c)
    bn.load_state_dict({"weight": _t(v["params"]["scale"]),
                        "bias": _t(v["params"]["bias"]),
                        "running_mean": _t(v["batch_stats"]["mean"]),
                        "running_var": _t(v["batch_stats"]["var"])})
    return jbn, v, bn, x


def test_batchnorm_eval_and_train_match_flax():
    rng = np.random.RandomState(1)
    jbn, v, bn, x = _bn_pair(rng, 4)
    ref = np.asarray(jbn.apply(v, x, train=False))
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach(),
                               ref, atol=1e-5, rtol=1e-5)
    ref_t, upd = jbn.apply(v, x, train=True, mutable=["batch_stats"])
    got_t = bn.train()(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(got_t, np.asarray(ref_t), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean,
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var,
                               np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)
    # the biased batch variance, with flax's momentum 0.9
    biased = x.astype(np.float64).var(axis=(0, 1, 3, 4))
    np.testing.assert_allclose(
        bn.running_var, 0.9 * v["batch_stats"]["var"] + 0.1 * biased,
        atol=1e-5, rtol=1e-5)


def test_batchnorm_affine_only_matches_flax():
    rng = np.random.RandomState(2)
    jbn, v, bn, _ = _bn_pair(rng, 6)
    dummy = jnp.zeros((1, 1, 6, 1, 1))
    inv, shift = jbn.apply(v, dummy, train=False, affine_only=True)
    got_inv, got_shift = bn.affine_only()
    np.testing.assert_allclose(got_inv.detach(), np.asarray(inv), rtol=1e-6)
    np.testing.assert_allclose(got_shift.detach(), np.asarray(shift),
                               atol=1e-6, rtol=1e-6)


def test_prelu_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 5, 4, 4).astype(np.float32)
    alpha = rng.rand(5).astype(np.float32)
    ref = np.asarray(jl.PReLU(channel_axis=2).apply(
        {"params": {"alpha": alpha}}, x))
    p = tl.PReLU(5)
    p.load_state_dict({"alpha": _t(alpha)})
    np.testing.assert_allclose(p(torch.from_numpy(x)).detach(), ref,
                               atol=0, rtol=0)


@pytest.mark.parametrize("train", [False, True])
def test_convbnact_kl_matches_flax(train):
    """Eval: BN + PReLU fused into the conv epilogue (the Pallas kernel in
    interpret mode on the JAX side); train: conv, batch-stat BN, PReLU."""
    rng = np.random.RandomState(4)
    xk = rng.randn(1, 4, 16, 4, 32).astype(np.float32)  # [N, D, C, H, W]
    block = jl.ConvBNAct(8, lane_pad="pallas", layout="kl")
    v = flax.core.unfreeze(block.init(jax.random.PRNGKey(0), xk,
                                      train=False))
    v["batch_stats"]["BatchNorm3D_0"] = {
        "mean": rng.randn(8).astype(np.float32),
        "var": (rng.rand(8) + 0.5).astype(np.float32)}
    v["params"]["Activation_0"]["PReLU_0"]["alpha"] = rng.rand(8).astype(
        np.float32)
    if train:
        ref, _ = block.apply(v, xk, train=True, mutable=["batch_stats"])
    else:
        ref = block.apply(v, xk, train=False)
    p, s = v["params"], v["batch_stats"]
    port = tl.ConvBNAct(16, 8)
    port.load_state_dict({
        "conv1.weight": _t(np.transpose(p["Conv_0"]["kernel"],
                                        (4, 3, 0, 1, 2))),
        "conv1.bias": _t(p["Conv_0"]["bias"]),
        "bn1.weight": _t(p["BatchNorm3D_0"]["scale"]),
        "bn1.bias": _t(p["BatchNorm3D_0"]["bias"]),
        "bn1.running_mean": _t(s["BatchNorm3D_0"]["mean"]),
        "bn1.running_var": _t(s["BatchNorm3D_0"]["var"]),
        "relu1.alpha": _t(p["Activation_0"]["PReLU_0"]["alpha"])})
    port.train(train)
    got = port(torch.from_numpy(xk)).detach()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_channel_dropout_identity_at_eval_whole_channels_in_train():
    x = torch.ones(2, 3, 8, 4, 4)
    drop = tl.ChannelDropout(torch.Generator().manual_seed(0))
    assert drop.eval()(x) is x
    y = drop.train()(x)
    per_channel = y.amax(dim=(1, 3, 4))  # [N, C]: 0 (dropped) or 2
    assert set(per_channel.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(y.amin(dim=(1, 3, 4)), per_channel)
    again = tl.ChannelDropout(torch.Generator().manual_seed(0)).train()(x)
    assert torch.equal(y, again)
