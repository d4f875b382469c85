"""The port's whole-volume inference (medicalseg_torch.core.sliding_window,
core.infer) against the JAX package's, on a small V-Net whose weights are
moved by utils.transplant. float32 throughout; 2e-4 on the logits, the
whole-net tolerance of tests/test_torch_vnet.py (16 convs summed in another
order), the blend adding only a weighted mean on top.
"""
import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from medicalseg_tpu.core import infer as jinfer
from medicalseg_tpu.core import sliding_window as jsw
from medicalseg_tpu.models import VNet as JVNet
from medicalseg_torch.core import infer as tinfer
from medicalseg_torch.core import sliding_window as tsw
from medicalseg_torch.models import VNet
from medicalseg_torch.utils import state_dict_from_flax

ROI = (16, 16, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets():
    """(JAX model, its variables, the port's model with the same weights);
    BatchNorm statistics are non-trivial."""
    rng = np.random.RandomState(0)
    jmodel = JVNet(in_channels=1, num_classes=3)
    variables = jax.jit(lambda k, a: jmodel.init(k, a, train=False))(
        jax.random.PRNGKey(5), jnp.zeros((1,) + ROI + (1,)))
    stats = jax.tree_util.tree_map(
        lambda leaf: (0.5 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32),
        flax.core.unfreeze(variables["batch_stats"]))
    variables = {"params": jax.device_get(
        flax.core.unfreeze(variables["params"])), "batch_stats": stats}
    model = VNet(num_classes=3)
    model.load_state_dict(state_dict_from_flax(variables))
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("in_size,roi,overlap", [
    (16, 16, 0.25), (8, 16, 0.25), (32, 16, 0.5), (200, 128, 0.25),
    (512, 128, 0.25), (20, 16, 0.25), (37, 8, 0.9), (9, 4, 0.99),
    (129, 128, 0.0)])
def test_window_starts_equal(in_size, roi, overlap):
    starts = tsw.compute_window_starts(in_size, roi, overlap)
    assert starts == jsw.compute_window_starts(in_size, roi, overlap)
    assert starts[0] == 0 and starts[-1] == max(in_size - roi, 0)


@pytest.mark.parametrize("roi", [(8, 8, 8), (16, 12, 5), (1, 4, 128)])
def test_gaussian_importance_equal(roi):
    got = tsw.gaussian_importance(roi)
    ref = np.asarray(jsw.gaussian_importance(roi))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.max() == 1.0 and got.min() > 0


@pytest.mark.parametrize("blend", ["gaussian", "constant"])
def test_sliding_window_matches_jax_on_vnet(nets, blend):
    """20 x 16 x 24 under a 16^3 window: 2 x 1 x 2 = 4 windows in batches
    of 3, the last batch short here and padded with masked duplicates
    there."""
    jmodel, variables, model = nets
    vol = np.random.RandomState(1).rand(20, 16, 24, 1).astype(np.float32)
    ref = np.asarray(jsw.sliding_window_inference(
        jmodel.apply, variables, jnp.asarray(vol), ROI, num_classes=3,
        overlap=0.25, window_batch=3, blend=blend))
    got = tsw.sliding_window_inference(
        model.main_output, torch.from_numpy(vol), ROI, num_classes=3,
        overlap=0.25, window_batch=3, blend=blend)
    assert tuple(got.shape) == (20, 16, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_batched_sliding_window_pads_small_volumes_like_jax(nets):
    """Two 12 x 16 x 20 volumes: D is smaller than the window (padded,
    cropped back), W needs two windows; 4 windows in batches of 3 mix the
    volumes. The batched result equals the per-volume one."""
    jmodel, variables, model = nets
    vols = np.random.RandomState(2).rand(2, 12, 16, 20, 1).astype(np.float32)
    ref = np.asarray(jsw.sliding_window_inference_batched(
        jmodel.apply, variables, jnp.asarray(vols), ROI, num_classes=3,
        overlap=0.25, window_batch=3))
    got = tsw.sliding_window_inference_batched(
        model.main_output, torch.from_numpy(vols), ROI, num_classes=3,
        overlap=0.25, window_batch=3)
    assert tuple(got.shape) == (2, 12, 16, 20, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    for i in range(2):
        single = tsw.sliding_window_inference(
            model.main_output, torch.from_numpy(vols[i]), ROI,
            num_classes=3, overlap=0.25, window_batch=4)
        np.testing.assert_allclose(got[i].numpy(), single.numpy(), atol=1e-5)


def test_one_flush_window_is_the_direct_forward(nets):
    _, _, model = nets
    vol = torch.from_numpy(
        np.random.RandomState(3).rand(*ROI, 1).astype(np.float32))
    with torch.inference_mode():
        direct = model(vol[None])[0][0]
    tiled = tsw.sliding_window_inference(model.main_output, vol, ROI,
                                         num_classes=3)
    # as in the JAX package the weight is floored at 1e-8, above the
    # Gaussian's value in the window's far corners: there a voxel that only
    # one window covers keeps its logits' signs and order, scaled down
    inner = tsw.gaussian_importance(ROI) >= 1e-8
    assert 0.99 < inner.float().mean() < 1
    np.testing.assert_allclose(tiled[inner].numpy(), direct[inner].numpy(),
                               atol=1e-5)
    assert torch.equal(tiled.argmax(-1), direct.argmax(-1))
    flat = tsw.sliding_window_inference(model.main_output, vol, ROI,
                                        num_classes=3, blend="constant")
    np.testing.assert_allclose(flat.numpy(), direct.numpy(), atol=1e-6)


def test_overlapping_windows_of_one_batch_all_count():
    """A voxel-wise model makes the blend exact whatever the overlap: a
    scatter that dropped one of two overlapping windows of a batch would
    leave its weight out and show."""
    class Pointwise(torch.nn.Module):
        def forward(self, x):
            return torch.cat([2 * x + 1, -x, x * x], dim=-1)

    vol = torch.from_numpy(
        np.random.RandomState(4).rand(20, 20, 20, 1).astype(np.float32))
    full = Pointwise()(vol[None])[0]
    for blend in ("gaussian", "constant"):
        tiled = tsw.sliding_window_inference(
            Pointwise(), vol, (8, 8, 8), num_classes=3, overlap=0.5,
            window_batch=3, blend=blend)
        np.testing.assert_allclose(tiled.numpy(), full.numpy(), atol=1e-5)


class Resize3D:
    """Stands in for the transform of that name: the reverse list matches
    by class name and reads ``size``."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("size", [12, (10, 12, 14)])
def test_reverse_transform_matches_jax(size):
    transforms = [Resize3D(size), object(), Resize3D((6, 6, 6))]
    ori = (9, 11, 13)
    assert tinfer.get_reverse_list(ori, transforms) == \
        jinfer.get_reverse_list(ori, transforms)
    logit = np.random.RandomState(6).rand(2, 6, 6, 6, 3).astype(np.float32)
    got = tinfer.reverse_transform(torch.from_numpy(logit), ori, transforms)
    ref = np.asarray(jinfer.reverse_transform(jnp.asarray(logit), ori,
                                              transforms))
    assert tuple(got.shape) == (2, 9, 11, 13, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_inference_matches_jax(nets):
    jmodel, variables, model = nets
    im = np.random.RandomState(7).rand(1, *ROI, 1).astype(np.float32)
    transforms = [Resize3D(16)]
    for ori in (None, (20, 18, 16)):
        pred, logit = tinfer.inference(model.main_output,
                                       torch.from_numpy(im), ori, transforms)
        jpred, jlogit = jinfer.inference(jmodel.apply, variables,
                                         jnp.asarray(im), ori, transforms)
        assert pred.dtype == torch.int32
        assert tuple(pred.shape) == np.asarray(jpred).shape
        np.testing.assert_allclose(logit.numpy(), np.asarray(jlogit),
                                   atol=2e-4)
        assert (pred.numpy() == np.asarray(jpred)).mean() >= 0.999
