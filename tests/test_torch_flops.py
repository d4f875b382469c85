"""The forward's FLOPs count of the port (medicalseg_torch.utils.flops and
``core.train``'s end-of-training report) against the JAX package's report,
which takes XLA's cost analysis of the jitted forward, on the CPU.

The count is twice the in-bounds multiply-adds of the convolutions; XLA's
figure also holds the elementwise work (BatchNorm, activations, the heads'
upsample), so the two agree within 1% (measured 0.2% for V-Net at 16^3 and
0.4% for VNetDeepSup at the spine geometry), not exactly. The in-bounds
count of one axis is checked exactly against a convolution of ones. The
JAX forward is compiled once per model (module fixture).
"""
import logging
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from medicalseg_tpu.core.train import _flops_report as jax_flops_report
from medicalseg_tpu.models import VNet as JVNet
from medicalseg_tpu.models import VNetDeepSup as JVNetDeepSup
from medicalseg_torch.core.train import train
from medicalseg_torch.cvlibs import config as tconfig
from medicalseg_torch.models import VNet, VNetDeepSup
from medicalseg_torch.utils import transplant
from medicalseg_torch.utils.flops import forward_flops, window_taps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPINE = os.path.join(ROOT, "configs", "synthetic",
                     "vnetdeepsup_synspine_15k.yml")
SPINE_KS = ((4, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))
SPINE_SS = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2))
XLA_REL = 1e-2
# (JAX model, port model, input shape NDHWC)
MODELS = {
    "vnet-16": (lambda: JVNet(in_channels=1, num_classes=3),
                lambda: VNet(num_classes=3), (1, 16, 16, 16, 1)),
    "deepsup-spine": (lambda: JVNetDeepSup(in_channels=1, num_classes=20,
                                           kernel_size=SPINE_KS,
                                           stride_size=SPINE_SS),
                      lambda: VNetDeepSup(num_classes=20,
                                          kernel_size=SPINE_KS,
                                          stride_size=SPINE_SS),
                      (1, 8, 32, 32, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Lines(logging.Handler):
    """The messages of one package's logger while it is attached."""

    def __init__(self, name):
        super().__init__()
        self.lines, self._logger = [], logging.getLogger(name)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)


def _gflops(lines):
    """(GFLOPs, batch) of the one ``Model forward cost`` line."""
    found = [ln for ln in lines if ln.startswith("Model forward cost: ")]
    assert len(found) == 1, lines
    value, rest = found[0][len("Model forward cost: "):].split(" GFLOPs")
    return float(value), int(rest.split("batch ")[1].rstrip(")"))


@pytest.fixture(scope="module")
def jax_reports():
    """Each model's JAX variables (seeded init) and the JAX loop's report
    of its forward, one compile a model."""
    out = {}
    for name, (jmodel_fn, _, shape) in MODELS.items():
        jmodel = jmodel_fn()
        sample = jnp.zeros(shape, jnp.float32)
        variables = jax.jit(lambda k, a: jmodel.init(k, a, train=False))(
            jax.random.PRNGKey(0), sample)
        state = SimpleNamespace(apply_fn=jmodel.apply, variables=variables)
        with _Lines("medicalseg_tpu") as log:
            jax_flops_report(state, sample)
        out[name] = (jax.device_get(variables), _gflops(log.lines))
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 16])
def test_same_conv_counts_the_in_bounds_taps_exactly(n):
    """Of a 5-tap SAME axis: sum over o of #{k : 0 <= o + k - 2 < n}, by
    hand and as the sum of a convolution of ones."""
    by_hand = sum(sum(1 for k in range(5) if 0 <= o + k - 2 < n)
                  for o in range(n))
    ones = F.conv1d(torch.ones(1, 1, n, dtype=torch.float64),
                    torch.ones(1, 1, 5, dtype=torch.float64), padding=2)
    assert window_taps(n, n, 5, 1, 2) == by_hand == int(ones.sum())
    assert by_hand == {1: 1, 2: 4, 3: 9, 16: 74}[n]


@pytest.mark.parametrize("n,k,s", [(5, 2, 2), (8, 4, 1), (3, 2, 2),
                                   (7, 3, 2)])
def test_strided_and_transposed_axes_count_what_they_read(n, k, s):
    """A VALID strided axis reads every tap; a VALID transposed one reads
    each input element k times (the holes of its dilated input read
    nothing): the sums of convolutions of ones."""
    x = torch.ones(1, 1, n, dtype=torch.float64)
    w = torch.ones(1, 1, k, dtype=torch.float64)
    down = F.conv1d(x, w, stride=s)
    up = F.conv_transpose1d(x, w, stride=s)
    assert window_taps(n, down.shape[-1], k, s) == int(down.sum())
    assert window_taps(n, up.shape[-1], k, 1, k - 1, s) == int(up.sum()) \
        == n * k


@pytest.mark.parametrize("name", list(MODELS))
def test_count_is_within_one_percent_of_the_jax_report(jax_reports, name):
    """The port's count on the transplanted model and the same input
    against the JAX ``_flops_report``'s XLA figure, and at batch 3 three
    times the batch-1 count."""
    _, port_fn, shape = MODELS[name]
    variables, (jax_gflops, jax_batch) = jax_reports[name]
    model = port_fn()
    model.load_state_dict(transplant.state_dict_from_flax(variables))
    got = forward_flops(model, shape[1:4], shape[0])
    assert jax_batch == shape[0]
    assert abs(got / 1e9 - jax_gflops) <= XLA_REL * jax_gflops, (got,
                                                                 jax_gflops)
    assert forward_flops(model, shape[1:4], 3) == 3 * got


def test_cpu_train_logs_the_forward_cost(tmp_path):
    """``core.train`` on the CPU ends with the JAX loop's line for the
    global batch at the sample shape: the flagship YAML cut to float32 and
    (8, 32, 32) volumes, batch 2, one iteration."""
    phase0 = tmp_path / "phase0"
    rng = np.random.RandomState(0)
    lines = []
    for i in range(2):
        for kind, arr in (("images", rng.rand(8, 32, 32).astype(np.float32)),
                          ("labels", rng.randint(0, 20, (8, 32, 32))
                           .astype(np.uint8))):
            os.makedirs(phase0 / kind, exist_ok=True)
            np.save(phase0 / kind / "v{}.npy".format(i), arr)
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    for name in ("train_list.txt", "val_list.txt"):
        with open(phase0 / name, "w") as f:
            f.writelines(lines)
    with open(SPINE) as f:
        cfg = yaml.safe_load(f)
    cfg["data_root"] = str(tmp_path)
    for key in ("train_dataset", "val_dataset"):
        cfg[key]["dataset_root"] = "phase0"
        cfg[key]["result_dir"] = "phase1"
    cfg["model"].update({"dtype": "float32", "remat": False})
    path = tmp_path / "spine.yml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    config = tconfig.Config(str(path), iters=1, batch_size=2)
    model = config.model
    with _Lines("medicalseg_torch") as log:
        train(model, config.train_dataset, optimizer=config.build_optimizer,
              lr_scheduler=config.lr_scheduler, save_dir=str(tmp_path / "o"),
              iters=1, batch_size=2, losses=config.loss, log_iters=1,
              seed=0, device="cpu")
    shutil.rmtree(tmp_path / "o")  # a checkpoint of 370 MB
    gflops, batch = _gflops(log.lines)
    assert batch == 2
    assert gflops == float("{:.3f}".format(
        forward_flops(model, (8, 32, 32), 2) / 1e9))
