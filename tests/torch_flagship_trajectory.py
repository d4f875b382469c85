"""Loss trajectories of the flagship recipe in the JAX package and in the
port, side by side, on the CPU (a script, not a test: the JAX train step's
compile takes minutes).

    python tests/torch_flagship_trajectory.py [steps]

The flagship's VNetDeepSup (spine kernels and strides, 20 classes,
float32, channel dropout on in both, each drawing its own masks), its four
MixedLoss heads, SGD with momentum 0.9, coupled weight decay 1e-4 and the
poly LR of ``configs/synthetic/vnetdeepsup_synspine_15k.yml``, from the
same weights (moved by ``utils/transplant.py``), ``steps`` steps on one
fixed batch of two spine volumes of ``tools/generate_synthetic_dataset.py``
(seed 7) cut to 8 x 128 x 128 (slices 2-9, every fourth row and column).
The JAX losses run in their loop form (``MEDSEG_LOSS_FUSED=0``), the one
the port implements. Prints both lists of losses.
"""
import os
import sys

os.environ["MEDSEG_LOSS_FUSED"] = "0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from generate_synthetic_dataset import make_volume_spine  # noqa: E402
from medicalseg_tpu.core import state as jstate  # noqa: E402
from medicalseg_tpu.models import VNetDeepSup as JVNetDeepSup  # noqa: E402
from medicalseg_tpu.models import losses as jlosses  # noqa: E402
from medicalseg_torch.core.state import (TrainState,  # noqa: E402
                                         make_train_step)
from medicalseg_torch.cvlibs.config import Config  # noqa: E402
from medicalseg_torch.models import VNetDeepSup  # noqa: E402
from medicalseg_torch.utils import transplant  # noqa: E402

FLAGSHIP = os.path.join(ROOT, "configs", "synthetic",
                        "vnetdeepsup_synspine_15k.yml")
KS = ((4, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2))
SS = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2))


def batch():
    rng = np.random.RandomState(7)
    images, labels = [], []
    for _ in range(2):
        img, lab = make_volume_spine(rng)
        images.append(img[2:10, ::4, ::4] / 255.0)
        labels.append(lab[2:10, ::4, ::4])
    return (np.stack(images)[..., None].astype(np.float32),
            np.stack(labels).astype(np.int32))


def main(steps):
    images, labels = batch()
    model = JVNetDeepSup(in_channels=1, num_classes=20, kernel_size=KS,
                         stride_size=SS, head_conv="pallas",
                         mid_conv="pallas")
    tx = optax.chain(optax.add_decayed_weights(1e-4), optax.sgd(
        optax.polynomial_schedule(0.01, 0.0, 0.9, 15000), momentum=0.9))
    state = jstate.TrainState.create(model, tx, jnp.asarray(images),
                                     jax.random.PRNGKey(3))
    start = flax.core.unfreeze(jax.device_get(state.variables))
    losses = {"types": [jlosses.MixedLoss(
        [jlosses.CrossEntropyLoss(), jlosses.DiceLoss()], [1.0, 1.0])
        for _ in range(4)], "coef": [0.25] * 4}
    step = jax.jit(jstate.make_train_step(losses))
    theirs = []
    for _ in range(steps):
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                              jax.random.PRNGKey(0))
        theirs.append(float(metrics["loss"]))
    print("jax ", [round(v, 4) for v in theirs])

    cfg = Config(FLAGSHIP)
    port = VNetDeepSup(num_classes=20, kernel_size=KS, stride_size=SS)
    port.load_state_dict(transplant.state_dict_from_flax(start))
    tstate = TrainState.create(port, cfg.build_optimizer, cfg.lr_scheduler,
                               device="cpu")
    tstep = make_train_step(cfg.loss)
    ours = []
    for _ in range(steps):
        tstate, metrics = tstep(tstate, images, labels)
        ours.append(metrics["loss"].item())
    print("port", [round(v, 4) for v in ours])


if __name__ == "__main__":
    torch.set_num_threads(os.cpu_count() or 1)
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12)
