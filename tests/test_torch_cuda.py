"""The port's CUDA kernels on the card, held to their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has no JAX, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: bf16 atol = rtol = 2e-2 (one bf16 ulp at outputs of magnitude
~1, as tests/test_pallas_conv5.py uses); f32 1e-4 for one conv (the
kernel's f32 sums against the plain version's, in another order) and the
2e-4 / 1e-3 of tests/test_torch_vnet.py for the whole net, with TF32 off.
"""
import numpy as np
import pytest
import torch
import yaml

from medicalseg_torch.core.state import TrainState, make_train_step
from medicalseg_torch.deploy import infer
from medicalseg_torch.models import VNet
from medicalseg_torch.models.losses import (CrossEntropyLoss, DiceLoss,
                                            MixedLoss)
from medicalseg_torch.ops import conv5 as c5

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _conv_inputs(shape_kl, co, dev, seed=0):
    """x [N, D, Ci, H, W], w [5, 5, 5, Ci, Co], b and ep [Co], from numpy."""
    rng = np.random.RandomState(seed)
    ci = shape_kl[2]
    x = rng.randn(*shape_kl).astype(np.float32)
    w = (rng.randn(5, 5, 5, ci, co) / np.sqrt(125 * ci)).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    ep = ((0.5 + rng.rand(co)).astype(np.float32),
          rng.randn(co).astype(np.float32), rng.rand(co).astype(np.float32))
    return (torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(b).to(dev),
            tuple(torch.from_numpy(v).to(dev) for v in ep))


def _close(got, ref, dtype):
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# (kind, [N, D, Ci, H, W], Co): the serving shapes' forms at a small extent,
# ragged channel counts (Ci not a multiple of 16, Co not of 8) and extents
# that fill no tile (H = 7, W = 100), and the 256-channel deep level
CASES = [("head", (2, 6, 32, 16, 32), 3),
         ("head", (2, 6, 64, 16, 32), 64),
         ("head", (1, 3, 24, 7, 100), 33),
         ("head", (1, 5, 3, 9, 10), 40),
         ("head", (2, 8, 256, 8, 8), 256),
         ("stem", (2, 6, 1, 16, 32), 16)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("kind,shape,co", CASES,
                         ids=["{}-{}-{}".format(k, s[2], c)
                              for k, s, c in CASES])
def test_conv5_kernel_matches_plain(dev, kind, shape, co, fused, dtype):
    x, w, b, ep = _conv_inputs(shape, co, dev)
    x = x.to(dtype)
    ep = ep if fused else None
    got = (c5.conv5_kl_fused(x, w, b, ep, kind) if fused else
           c5.conv5_kl(x, w, b, kind))
    torch.cuda.synchronize()
    assert got.shape == (*shape[:2], co, *shape[3:]) and got.dtype == dtype
    _close(got, c5.conv5_kl_plain(x, w, b, ep), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_conv5_reads_a_strided_view(dev, dtype):
    """A [N, C, D, H, W] tensor seen as [N, D, C, H, W]: the kernel takes
    its strides and copies nothing."""
    x, w, b, ep = _conv_inputs((2, 6, 16, 12, 20), 16, dev, seed=1)
    x = x.to(dtype)
    view = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous() and torch.equal(view, x)
    got = c5.conv5_kl_fused(view, w, b, ep)
    _close(got, c5.conv5_kl_plain(x, w, b, ep), dtype)


# backward kernels: (kind, [N, D, Ci, H, W], Co) at the forms of the train
# step (stem, narrow head, square, wide) plus ragged channels and extents
BWD_CASES = [("stem", (2, 6, 1, 16, 32), 16),
             ("head", (2, 6, 32, 16, 32), 3),
             ("head", (2, 6, 32, 16, 32), 32),
             ("head", (1, 6, 64, 8, 16), 64),
             ("head", (2, 4, 256, 8, 8), 256),
             ("head", (1, 3, 24, 7, 100), 33),
             ("head", (1, 5, 3, 9, 10), 40),
             ("head", (1, 2, 5, 3, 3), 1)]
BWD_IDS = ["{}-{}-{}".format(k, s[2], c) for k, s, c in BWD_CASES]


def _scaled_close(got, ref, dtype):
    """atol relative to the reference's magnitude: dW sums one product per
    voxel, so its entries grow with the voxel count."""
    scale = max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=TOL[dtype] * scale, rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,shape,co", BWD_CASES, ids=BWD_IDS)
def test_conv5_wgrad_kernel_matches_plain(dev, kind, shape, co, dtype):
    x, _, _, _ = _conv_inputs(shape, co, dev)
    g = torch.from_numpy(np.random.RandomState(9).randn(
        *shape[:2], co, *shape[3:]).astype(np.float32)).to(dev)
    x, g = x.to(dtype), g.to(dtype)
    c5.reset_launches()
    got = c5.conv5_wgrad_kl(x, g, kind)
    torch.cuda.synchronize()
    form = c5.conv5_wgrad_geometry(shape[0], shape[1], shape[3], shape[4],
                                   shape[2], co, kind)["form"]
    assert c5.LAUNCHES["conv5_wgrad_" + form] == 1
    assert got.shape == (5, 5, 5, shape[2], co)
    assert got.dtype == torch.float32
    _scaled_close(got, c5.conv5_wgrad_kl_plain(x, g), dtype)
    # deterministic: no atomics in the voxel reduction
    assert torch.equal(got, c5.conv5_wgrad_kl(x, g, kind))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,shape,co", BWD_CASES[1:], ids=BWD_IDS[1:])
def test_conv5_dgrad_kernel_matches_plain(dev, kind, shape, co, dtype):
    _, w, _, _ = _conv_inputs(shape, co, dev)
    g = torch.from_numpy(np.random.RandomState(9).randn(
        *shape[:2], co, *shape[3:]).astype(np.float32)).to(dev).to(dtype)
    c5.reset_launches()
    got = c5.conv5_dgrad_kl(g, w)
    torch.cuda.synchronize()
    assert c5.LAUNCHES["conv5_dgrad"] == 1 and c5.LAUNCHES["conv5_head"] == 0
    assert got.shape == shape and got.dtype == dtype
    _close(got, c5.conv5_dgrad_kl_plain(g, w), dtype)


def test_conv5_function_backward_on_the_card(dev):
    """conv5_kl's autograd Function on CUDA tensors: dx, dw and db through
    the kernels against autograd of F.conv3d (f32, TF32 off); a
    non-contiguous cotangent is pinned; the stem skips dx."""
    x, w, b, _ = _conv_inputs((2, 5, 6, 9, 12), 7, dev, seed=8)
    g = torch.randn((2, 5, 7, 12, 9), device=dev).transpose(3, 4)
    xa, wa, ba = (t.clone().requires_grad_(True) for t in (x, w, b))
    c5.reset_launches()
    c5.conv5_kl(xa, wa, ba).backward(g)
    assert c5.LAUNCHES["conv5_dgrad"] == 1 and c5.LAUNCHES["pin"] == 1
    assert c5.LAUNCHES["conv5_wgrad_head"] == 1
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    torch.nn.functional.conv3d(
        xr.transpose(1, 2), wr.permute(4, 3, 0, 1, 2), br,
        padding=2).transpose(1, 2).backward(g)
    for got, ref in ((xa.grad, xr.grad), (wa.grad, wr.grad),
                     (ba.grad, br.grad)):
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-4)
    xs = x[:, :, :1].contiguous()
    ws = w[:, :, :, :1].clone().requires_grad_(True)
    c5.reset_launches()
    c5.conv5_kl(xs, ws, b, "stem").sum().backward()
    assert c5.LAUNCHES["conv5_dgrad"] == 0
    assert c5.LAUNCHES["conv5_wgrad_stem"] == 1
    with pytest.raises(RuntimeError, match="no backward"):
        c5.conv5_kl_fused(xs, ws, b, (b, b, b), "stem")


def test_launch_counts_one_per_kernel_launch(dev):
    x, w, b, ep = _conv_inputs((1, 4, 16, 8, 16), 8, dev, seed=2)
    c5.reset_launches()
    c5.conv5_kl(x.bfloat16(), w, b)
    c5.conv5_kl_fused(x, w, b, ep)
    c5.conv5_kl_fused(x[:, :, :1].contiguous(), w[:, :, :, :1], b, ep,
                      kind="stem")
    c5.pin_kl(x)  # contiguous: no copy, no launch
    c5.pin_kl(x.transpose(1, 2))
    assert {k: v for k, v in c5.LAUNCHES.items() if v} == {
        "conv5_head": 2, "conv5_stem": 1, "conv5_fused_epilogue": 2,
        "pin": 1}


def test_wrappers_raise_instead_of_falling_back(dev):
    x, w, b, _ = _conv_inputs((1, 4, 16, 8, 16), 8, dev, seed=3)
    with pytest.raises(ValueError, match="contiguous"):
        c5.conv5_kl(x.transpose(3, 4), w, b)  # W is no longer stride 1
    with pytest.raises(RuntimeError, match="operands"):
        c5.conv5_kl(x, w.cpu(), b)
    with pytest.raises(ValueError, match="2- or 4-byte"):
        c5.pin_kl(x.double().transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("perm", [(0, 2, 1, 3, 4), (0, 4, 2, 1, 3)],
                         ids=["swap-d-c", "w-strided"])
def test_pin_matches_contiguous(dev, dtype, perm):
    src = torch.randn((2, 5, 6, 7, 9), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev).to(dtype)
    view = src.permute(*perm)
    got = c5.pin_kl(view)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, view.contiguous())


def _plain_path(monkeypatch):
    """Route the model's kernel launches to their plain versions."""
    monkeypatch.setattr(c5, "_conv5_forward", lambda xk, w, b, kind:
                        c5.conv5_kl_plain(xk, w, b))
    monkeypatch.setattr(c5, "conv5_kl_fused", lambda xk, w, b, ep,
                        kind="head": c5.conv5_kl_plain(xk, w, b, ep))
    monkeypatch.setattr(c5, "conv5_dgrad_kl", c5.conv5_dgrad_kl_plain)
    monkeypatch.setattr(c5, "conv5_wgrad_kl", lambda xk, gk, kind="head":
                        c5.conv5_wgrad_kl_plain(xk, gk))
    monkeypatch.setattr(c5, "_pin_forward", c5.pin_kl_plain)


def test_vnet_kernel_path_matches_plain_path(dev, monkeypatch):
    """A whole f32 eval forward on the card, kernels against plain
    versions, with non-trivial BN statistics. At 32^3 every level is
    wider than 1^3, so all 8 up/down conv outputs need a pin."""
    gen = torch.Generator().manual_seed(5)
    model = VNet(num_classes=3, generator=gen)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
        else:
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    model = model.to(dev).eval()
    x = torch.rand((2, 32, 32, 32, 1), generator=gen).to(dev)
    c5.reset_launches()
    with torch.inference_mode():
        got = model(x)[0]
        launches = dict(c5.LAUNCHES)
        with monkeypatch.context() as m:
            _plain_path(m)
            ref = model(x)[0]
    assert {k: v for k, v in launches.items() if v} == {
        "conv5_head": 15, "conv5_stem": 1, "conv5_fused_epilogue": 16,
        "pin": 8}
    assert got.shape == (2, 32, 32, 32, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype,remat", [(torch.float32, False),
                                         (torch.bfloat16, True)],
                         ids=["f32", "bf16-remat"])
def test_train_step_on_the_card_gives_every_parameter_a_gradient(
        dev, dtype, remat):
    """The conv5 and pin wrappers are autograd Functions: a train step on
    the card reaches every parameter through the backward kernels (a
    wrapper that returned a detached result would leave all but the last
    layers without a gradient). In f32 the updated weights are held to the
    plain-version path's from the same start."""
    rng = np.random.RandomState(7)
    images = rng.rand(2, 32, 32, 32, 1).astype(np.float32)
    labels = rng.randint(0, 3, (2, 32, 32, 32)).astype(np.uint8)
    losses = {"types": [MixedLoss([CrossEntropyLoss(), DiceLoss()], [1, 1])],
              "coef": [1]}

    def trainer():
        model = VNet(num_classes=3, dtype=dtype, remat=remat,
                     generator=torch.Generator().manual_seed(8))
        return TrainState.create(
            model, lambda p: torch.optim.SGD(p, lr=0.01, momentum=0.9,
                                             weight_decay=1e-4),
            lambda step: 0.01, seed=9)

    state = trainer()
    assert state.device.type == "cuda" and state.generator.device.type == \
        "cuda"
    c5.reset_launches()
    state, metrics = make_train_step(losses)(state, images, labels)
    torch.cuda.synchronize()
    assert metrics["loss"].device.type == "cuda"
    assert torch.isfinite(metrics["loss"]) and state.step == 1
    fwd = 2 if remat else 1
    assert c5.LAUNCHES["conv5_head"] == 15 * fwd
    assert c5.LAUNCHES["conv5_stem"] == fwd
    assert c5.LAUNCHES["conv5_dgrad"] == 15
    assert (c5.LAUNCHES["conv5_wgrad_stem"], c5.LAUNCHES["conv5_wgrad_head"],
            c5.LAUNCHES["conv5_wgrad_mid"]) == (1, 1, 14)
    assert c5.LAUNCHES["conv5_fused_epilogue"] == 0
    for name, p in state.model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    if dtype == torch.float32:
        ref = trainer()
        with pytest.MonkeyPatch.context() as m:
            _plain_path(m)
            ref, ref_metrics = make_train_step(losses)(ref, images, labels)
        torch.testing.assert_close(metrics["loss"], ref_metrics["loss"],
                                   atol=1e-5, rtol=1e-4)
        # relative L2 per leaf (f32 sums in another order, amplified by
        # the random-init net: measured 4e-3 at worst). A conv bias that
        # feeds a BatchNorm has a zero gradient up to rounding: held
        # relative to its conv's weight gradient.
        want = dict(ref.model.named_parameters())
        for name, a in state.model.named_parameters():
            scale = want[name].grad.norm()
            if name.endswith(("conv1.bias", "down_conv.bias",
                              "up_conv.bias")):
                scale = want[name[:-4] + "weight"].grad.norm()
            rel = (a.grad - want[name].grad).norm() / scale.clamp_min(1e-30)
            assert rel < 2e-2, (name, rel.item())


def test_predictor_serves_on_the_card(dev, tmp_path):
    model_cfg = {"type": "VNet", "num_classes": 2, "dtype": "bfloat16"}
    gen = torch.Generator().manual_seed(6)
    torch.save(VNet(num_classes=2, generator=gen).state_dict(),
               tmp_path / "model.pt")
    (tmp_path / "deploy.yaml").write_text(yaml.dump({"Deploy": {
        "model": "model.stablehlo", "params": "model.pt", "transforms": [],
        "output_op": "argmax", "model_config": model_cfg}}))
    imgs = tmp_path / "images"
    imgs.mkdir()
    for i in range(3):
        np.save(imgs / "v{}.npy".format(i),
                np.random.RandomState(i).rand(16, 16, 16).astype(np.float32))
    args = infer.parse_args(["--config", str(tmp_path / "deploy.yaml"),
                             "--image_path", str(imgs), "--save_dir",
                             str(tmp_path / "pred"), "--batch_size", "2"])
    predictor = infer.Predictor(args)
    assert predictor.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in predictor.model.parameters())
    c5.reset_launches()
    saved = predictor.run(sorted(str(p) for p in imgs.iterdir()))
    # one warm-up and two batches (2 + 1 volumes)
    assert c5.LAUNCHES["conv5_fused_epilogue"] == 3 * 16
    for path in saved:
        pred = np.load(path)
        assert pred.shape == (16, 16, 16) and pred.dtype == np.int32
        assert set(np.unique(pred)) <= {0, 1}
