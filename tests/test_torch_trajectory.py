"""The two trainers run unbroken, side by side, on the CPU.

1. A trajectory: the JAX package's ``make_train_step`` and the port's
   train steps (the eager ``make_train_step``, and
   ``make_cached_train_step`` over a dataset held as tensors) start from
   the same weights and take 40 steps each on one seeded stream of
   batches, with no restart from the other trainer's state: a small
   encoder-decoder (the contract of ``tests/_mini_model.py``'s MiniSegNet
   without its dropout, a flax copy here and a torch copy carried across
   by name), float32, batch 2 at 16^3 (its one BatchNorm sees 8192
   samples a channel), the real recipe's MixedLoss(CE + Dice), SGD with
   momentum 0.9 and weight decay 1e-4 under a polynomial LR. At every
   step the loss, each class's soft dice and every parameter and
   BatchNorm statistic (relative L2 a leaf) are compared. Tolerances: loss within 2e-4 relative, dice
   within 1e-4, each leaf within 5e-4 relative L2, about five times the
   worst measured (loss 5.7e-5, dice 3.4e-6, a leaf 9.8e-5). The gap is
   there at step 0 and does not grow: on the same logits the JAX
   package's CPU cross-entropy is 4e-5 from the port's, whose float32
   value equals its float64 one, and the two convs' logits differ by
   1.5e-5. A difference in the dynamics moves the rare class's dice by
   0.02 to 0.25 a step.
2. The augmentation's draws as distributions: 2000 draws of the lung
   recipe (RandomResizedCrop3D(128, scale [0.8, 1.2]), RandomRotation3D(90),
   RandomFlip3D) from the JAX sampler (``_sample_crop_params`` and the
   rotation's and flip's draws, keyed as ``_augment_one`` keys them) and
   from the port's ``DeviceAugmentor.draw`` + ``params``. Crop sizes and
   starts per axis and the angle by a two-sample Kolmogorov-Smirnov test,
   the plane, the flip's gate and its axis by a chi-square test of
   homogeneity, each at the 0.1% level.
"""
import numpy as np
import pytest
from scipy import ndimage, stats

import jax
import jax.numpy as jnp
import optax
import torch
from flax import linen as nn

from medicalseg_tpu.core import state as jstate
from medicalseg_tpu.models import losses as jlosses
from medicalseg_tpu.transforms import device as jdevice
from medicalseg_torch.core.state import (TrainState, make_cached_train_step,
                                         make_train_step)
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.models import losses as tlosses
from medicalseg_torch.models.layers import BatchNorm3D
from medicalseg_torch.transforms import (DeviceAugmentor, RandomFlip3D,
                                         RandomResizedCrop3D,
                                         RandomRotation3D)

STEPS, BATCH, EDGE, CLASSES, BANK = 40, 2, 16, 3, 6
LR, MOMENTUM, WEIGHT_DECAY, POWER = 0.05, 0.9, 1e-4, 0.9
TOL_LOSS, TOL_DICE, TOL_PARAM = 2e-4, 1e-4, 5e-4
DRAWS, LEVEL = 2000, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxMiniSegNet(nn.Module):
    """``tests/_mini_model.py``'s MiniSegNet without its dropout."""
    num_classes: int = CLASSES
    features: int = 8

    @nn.compact
    def __call__(self, x, train: bool = True):
        h = nn.Conv(self.features, (3, 3, 3), padding="SAME")(x)
        h = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                         epsilon=1e-5)(h)
        h = nn.relu(h)
        d = nn.Conv(self.features * 2, (2, 2, 2), strides=(2, 2, 2),
                    padding="VALID")(h)
        u = nn.ConvTranspose(self.features, (2, 2, 2), strides=(2, 2, 2),
                             padding="VALID")(d)
        out = nn.Conv(self.num_classes, (1, 1, 1))(
            jnp.concatenate([u, h], axis=-1))
        return [out]


class TorchMiniSegNet(torch.nn.Module):
    """The same network in torch: NDHWC in, [NDHWC logits] out, the
    port's BatchNorm3D (flax's momentum and biased statistics)."""

    def __init__(self, num_classes=CLASSES, features=8):
        super().__init__()
        f = features
        self.conv0 = torch.nn.Conv3d(1, f, 3, padding=1)
        self.bn = BatchNorm3D(f)
        self.down = torch.nn.Conv3d(f, 2 * f, 2, stride=2)
        self.up = torch.nn.ConvTranspose3d(2 * f, f, 2, stride=2)
        self.head = torch.nn.Conv3d(2 * f, num_classes, 1)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)  # NCDHW
        h = self.conv0(x)
        # the port's BatchNorm3D works in [N, D, C, H, W]
        h = self.bn(h.transpose(1, 2)).transpose(1, 2).relu()
        u = self.up(self.down(h))
        out = self.head(torch.cat([u, h], dim=1))
        return [out.permute(0, 2, 3, 4, 1)]

    def load_flax(self, variables):
        """Copy a JaxMiniSegNet's variables in (flax ConvTranspose does not
        flip its kernel; torch's transposed conv does)."""
        p, bs = variables["params"], variables["batch_stats"]

        def conv(k):
            return torch.from_numpy(np.array(k).transpose(4, 3, 0, 1, 2)
                                    .copy())

        with torch.no_grad():
            for mod, name in ((self.conv0, "Conv_0"), (self.down, "Conv_1"),
                              (self.head, "Conv_2")):
                mod.weight.copy_(conv(p[name]["kernel"]))
                mod.bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
            k = np.asarray(p["ConvTranspose_0"]["kernel"])[::-1, ::-1, ::-1]
            self.up.weight.copy_(torch.from_numpy(
                k.transpose(3, 4, 0, 1, 2).copy()))
            self.up.bias.copy_(torch.from_numpy(np.array(
                p["ConvTranspose_0"]["bias"])))
            self.bn.weight.copy_(torch.from_numpy(np.array(
                p["BatchNorm_0"]["scale"])))
            self.bn.bias.copy_(torch.from_numpy(np.array(
                p["BatchNorm_0"]["bias"])))
            self.bn.running_mean.copy_(torch.from_numpy(np.array(
                bs["BatchNorm_0"]["mean"])))
            self.bn.running_var.copy_(torch.from_numpy(np.array(
                bs["BatchNorm_0"]["var"])))
        return self

    def leaves(self):
        """name -> numpy, in the flax layout of each leaf."""
        def conv(m):
            return m.weight.detach().numpy().transpose(2, 3, 4, 1, 0)
        return {k: np.array(v) for k, v in {
            "Conv_0/kernel": conv(self.conv0),
            "Conv_0/bias": self.conv0.bias.detach().numpy(),
            "Conv_1/kernel": conv(self.down),
            "Conv_1/bias": self.down.bias.detach().numpy(),
            "Conv_2/kernel": conv(self.head),
            "Conv_2/bias": self.head.bias.detach().numpy(),
            "ConvTranspose_0/kernel": self.up.weight.detach().numpy()
            .transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1],
            "ConvTranspose_0/bias": self.up.bias.detach().numpy(),
            "BatchNorm_0/scale": self.bn.weight.detach().numpy(),
            "BatchNorm_0/bias": self.bn.bias.detach().numpy(),
            "BatchNorm_0/mean": self.bn.running_mean.numpy(),
            "BatchNorm_0/var": self.bn.running_var.numpy(),
        }.items()}  # copies: the parameters move on


def flax_leaves(*trees):
    """name -> numpy of the leaves of ``params`` (and ``batch_stats``)."""
    return {"{}/{}".format(layer, name): np.asarray(v)
            for tree in trees for layer, leaves in tree.items()
            for name, v in leaves.items()}


def bank(seed=0):
    """``BANK`` smooth seeded volumes [EDGE^3] in [0, 1] and their labels:
    class 1 above one level, class 2 (small, like lesions) above a
    higher one."""
    rng = np.random.RandomState(seed)
    images, labels = [], []
    for _ in range(BANK):
        field = ndimage.gaussian_filter(rng.rand(EDGE, EDGE, EDGE), 2.0)
        field = (field - field.min()) / (field.max() - field.min())
        images.append(field.astype(np.float32))
        labels.append(((field > 0.55).astype(np.int64) +
                       (field > 0.8)).astype(np.int32))
    return np.stack(images), np.stack(labels)


def index_stream(steps, seed=1):
    """[steps, BATCH] indices into the bank: shuffled epochs, the loaders'
    ``RandomState`` permutation rule."""
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < steps * BATCH:
        out.extend(rng.permutation(BANK))
    return np.asarray(out[:steps * BATCH]).reshape(steps, BATCH)


def jax_losses():
    return {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}


def port_losses():
    return {"types": [tlosses.MixedLoss(
        [tlosses.CrossEntropyLoss(), tlosses.DiceLoss()], [1.0, 1.0])],
        "coef": [1]}


def jax_run(images, labels, stream):
    """The JAX trainer, unbroken: the start variables and, per step, (loss,
    per-class dice, params as numpy)."""
    tx = optax.chain(
        optax.add_decayed_weights(WEIGHT_DECAY),
        optax.sgd(optax.polynomial_schedule(LR, 0.0, POWER, STEPS),
                  momentum=MOMENTUM))
    state = jstate.TrainState.create(
        JaxMiniSegNet(), tx, jnp.zeros((BATCH, EDGE, EDGE, EDGE, 1)),
        jax.random.PRNGKey(3))
    start = jax.device_get(state.variables)
    step = jax.jit(jstate.make_train_step(jax_losses()))
    key = jax.random.PRNGKey(0)
    log = []
    for idx in stream:
        state, m = step(state, jnp.asarray(images[idx][..., None]),
                        jnp.asarray(labels[idx]), key)
        log.append((float(m["loss"]), np.asarray(m["per_channel_dice"]),
                    flax_leaves(*jax.device_get((state.params,
                                                 state.batch_stats)))))
    return start, log


def port_state(start):
    return TrainState.create(
        TorchMiniSegNet().load_flax(start),
        lambda p: torch.optim.SGD(p, lr=LR, momentum=MOMENTUM,
                                  weight_decay=WEIGHT_DECAY),
        tconfig.polynomial_decay(LR, STEPS, 0.0, POWER), seed=0,
        device="cpu", capturable_optimizer=True)


@pytest.fixture(scope="module")
def trajectories():
    images, labels = bank()
    stream = index_stream(STEPS)
    start, jlog = jax_run(images, labels, stream)

    eager = TrainState.create(
        TorchMiniSegNet().load_flax(start),
        lambda p: torch.optim.SGD(p, lr=LR, momentum=MOMENTUM,
                                  weight_decay=WEIGHT_DECAY),
        tconfig.polynomial_decay(LR, STEPS, 0.0, POWER), seed=0,
        device="cpu")
    step = make_train_step(port_losses())
    elog = []
    for idx in stream:
        _, m = step(eager, images[idx][..., None], labels[idx])
        elog.append((m["loss"].item(), m["per_channel_dice"].numpy(),
                     eager.model.leaves()))

    cached = port_state(start)
    cstep = make_cached_train_step(port_losses(), n_steps=4)
    cache = (torch.from_numpy(images[..., None]), torch.from_numpy(labels))
    clog = []
    for rows in stream.reshape(-1, 4, BATCH):  # four updates a call
        _, m = cstep(cached, *cache, rows)
        for i in range(len(rows)):
            clog.append((m["loss"][i].item(),
                         m["per_channel_dice"][i].numpy(), None))
    clog[-1] = clog[-1][:2] + (cached.model.leaves(),)
    return jlog, elog, clog


# conv0's bias feeds a BatchNorm that cancels it: its gradient is zero but
# for rounding, and both trainers walk it through noise near 1e-7. It is
# held to stay that small instead of to the other trainer's value.
NOISE = "Conv_0/bias"


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_the_trainers_run_unbroken_along_one_trajectory(trajectories):
    jlog, elog, clog = trajectories
    assert len(jlog) == len(elog) == len(clog) == STEPS
    worst = {"loss": 0.0, "dice": 0.0, "param": 0.0}
    for i, ((jl, jd, jp), (el, ed, ep)) in enumerate(zip(jlog, elog)):
        worst["loss"] = max(worst["loss"], abs(el - jl) / abs(jl))
        worst["dice"] = max(worst["dice"], float(np.abs(ed - jd).max()))
        worst["param"] = max(worst["param"], max(
            _rel_l2(ep[k], jp[k]) for k in jp if k != NOISE))
        assert abs(el - jl) <= TOL_LOSS * abs(jl), (i, el, jl)
        np.testing.assert_allclose(ed, jd, atol=TOL_DICE, err_msg=str(i))
        for k in jp:
            if k == NOISE:
                assert max(np.abs(ep[k]).max(), np.abs(jp[k]).max()) < 1e-4
            else:
                assert _rel_l2(ep[k], jp[k]) <= TOL_PARAM, (i, k)
    # the trajectory goes somewhere: the loss falls and each class's
    # soft dice moves, the rare class's included
    assert jlog[-1][0] < 0.8 * jlog[0][0]
    assert np.all(np.abs(jlog[-1][1] - jlog[0][1]) > 0.02), (
        jlog[0][1], jlog[-1][1])
    print("worst differences over {} steps: {}".format(STEPS, worst))


def test_the_cached_step_is_the_eager_steps(trajectories):
    """Four updates a call over a dataset held as tensors, from an index
    matrix: the same numbers as forty eager steps, within 1e-5: the eager
    steps take batches in other strides, which the CPU convolution sums
    in another order, and an optimizer with a float learning rate."""
    _, elog, clog = trajectories
    for i, ((el, ed, _), (cl, cd, _)) in enumerate(zip(elog, clog)):
        assert abs(cl - el) <= 1e-5 * abs(el), (i, cl, el)
        np.testing.assert_allclose(cd, ed, atol=1e-5, err_msg=str(i))
    for k, v in elog[-1][2].items():
        if k != NOISE:
            assert _rel_l2(clog[-1][2][k], v) <= 1e-5, k


# --------------------------------------------------------------------------
# the augmentation's draws
# --------------------------------------------------------------------------
def _jax_draws(n, shape=(128, 128, 128)):
    crop = RandomResizedCrop3D(128, scale=[0.8, 1.2])
    rot = RandomRotation3D(90)
    flip = RandomFlip3D()

    def one(key):
        kc, kr, kf = jax.random.split(key, 3)  # _augment_one's split
        start, size = jdevice._sample_crop_params(kc, shape, crop.scale,
                                                  crop.ratio)
        ka, kp = jax.random.split(kr)
        angle = jax.random.uniform(ka, (), minval=rot.degrees[0],
                                   maxval=rot.degrees[1])
        plane = jax.random.randint(kp, (), 0, len(rot.rotate_planes))
        kp, ka = jax.random.split(kf)
        gate = jax.random.bernoulli(kp, flip.prob)
        axis = jax.random.randint(ka, (), 0, 3)
        return start, size, angle, plane, gate, axis

    keys = jax.random.split(jax.random.PRNGKey(11), n)
    out = jax.device_get(jax.jit(jax.vmap(one))(keys))
    return dict(zip(("start", "size", "angle", "plane", "gate", "axis"),
                    (np.asarray(v) for v in out)))


def _port_draws(n, shape=(128, 128, 128)):
    aug = DeviceAugmentor([RandomResizedCrop3D(128, scale=[0.8, 1.2]),
                           RandomRotation3D(90), RandomFlip3D()], seed=1)
    starts, sizes, angles, planes, gates, axes = [], [], [], [], [], []
    for draws in aug.draw(n, 5):
        (start, size), (angle, plane), mask = aug.params(draws, shape)
        starts.append(start)
        sizes.append(size)
        angles.append(angle)
        planes.append(aug.transforms[1].rotate_planes.index(list(plane)))
        gates.append(any(mask))
        axes.append(draws[2]["axis"])
    return {"start": np.asarray(starts), "size": np.asarray(sizes),
            "angle": np.asarray(angles), "plane": np.asarray(planes),
            "gate": np.asarray(gates), "axis": np.asarray(axes)}


def _chi2(a, b, values):
    table = [[int(np.sum(a == v)) for v in values],
             [int(np.sum(b == v)) for v in values]]
    return stats.chi2_contingency(table)[1]


def test_the_augmentation_draws_the_jax_distributions():
    ours, ref = _port_draws(DRAWS), _jax_draws(DRAWS)
    pvalues = {}
    for key in ("size", "start"):
        for ax in range(3):
            pvalues["{}[{}]".format(key, ax)] = stats.ks_2samp(
                ours[key][:, ax], ref[key][:, ax]).pvalue
    pvalues["angle"] = stats.ks_2samp(ours["angle"], ref["angle"]).pvalue
    pvalues["plane"] = _chi2(ours["plane"], ref["plane"], range(3))
    pvalues["gate"] = _chi2(ours["gate"], ref["gate"], (False, True))
    pvalues["axis"] = _chi2(ours["axis"], ref["axis"], range(3))
    print("p-values:", pvalues)
    assert min(pvalues.values()) > LEVEL, pvalues
    # the draws are not degenerate: both sides spread over the range
    assert ours["angle"].min() < -80 and ours["angle"].max() > 80
    assert len(np.unique(ours["size"][:, 0])) > 10
