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
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from medicalseg_torch.core.state import TrainState, make_train_step
from medicalseg_torch.deploy import infer
from medicalseg_torch.models import VNet
from medicalseg_torch.models.losses import (CrossEntropyLoss, DiceLoss,
                                            MixedLoss)
from medicalseg_torch.ops import conv5 as c5
from medicalseg_torch.ops import hu_resize as hr
from medicalseg_torch.ops import intensity, resize
from medicalseg_torch.tools.conv5_times import padded

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


# The bf16 stem on the tensor cores (stem_tc_kernel): (what, [N, D, 1, H,
# W], Co) at the V-Net stem, ragged tiles in h, w and depth chunks, Co <
# 16, and W not a multiple of 8 (element stores at the row's end)
STEM_CASES = [("vnet-1-16", (2, 6, 1, 16, 32), 16),
              ("chunks-h9-w40", (1, 20, 1, 9, 40), 16),
              ("co5-w7", (2, 3, 1, 5, 7), 5),
              ("w100", (1, 12, 1, 20, 100), 16)]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("what,shape,co", STEM_CASES,
                         ids=[c[0] for c in STEM_CASES])
def test_stem_tc_kernel_matches_plain_and_repeats(dev, what, shape, co,
                                                  fused):
    """Against the plain version (bf16 tolerance), bit for bit on a second
    launch, counted under its own key (and the epilogue's)."""
    x, w, b, ep = _conv_inputs(shape, co, dev, seed=4)
    x, ep = x.bfloat16(), ep if fused else None
    assert c5.conv5_form(x, co, "stem") == "stem_tc"

    def call():
        return (c5.conv5_kl_fused(x, w, b, ep, "stem") if fused else
                c5.conv5_kl(x, w, b, "stem"))

    c5.reset_launches()
    got = call()
    torch.cuda.synchronize()
    want = {"conv5_stem_tc": 1}
    if fused:
        want["conv5_fused_epilogue"] = 1
    assert {k: v for k, v in c5.LAUNCHES.items() if v} == want
    assert got.shape == (*shape[:2], co, *shape[3:])
    assert got.dtype == torch.bfloat16
    _close(got, c5.conv5_kl_plain(x, w, b, ep), torch.bfloat16)
    assert torch.equal(got, call())


def test_stem_tc_kernel_reads_a_strided_view(dev):
    """A depth slice of a wider tensor and a misaligned base: the kernel
    takes any W-contiguous view (its own strides, 2-byte loads)."""
    x, w, b, _ = _conv_inputs((1, 8, 1, 10, 24), 16, dev, seed=5)
    x = x.bfloat16()
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    for xv in (x[:, 2:7], view):
        c5.reset_launches()
        got = c5.conv5_kl(xv, w, b, "stem")
        torch.cuda.synchronize()
        assert c5.LAUNCHES["conv5_stem_tc"] == 1
        _close(got, c5.conv5_kl_plain(xv, w, b), torch.bfloat16)


def test_stem_tc_kernel_raises_on_what_it_cannot_take(dev):
    """W not the contiguous axis raises; 17 output channels are
    conv5_kernel's by the gate, and forced onto stem_tc_kernel the launch
    is refused and the wrapper raises; nothing falls back."""
    x, w, b, _ = _conv_inputs((1, 4, 1, 8, 16), 17, dev, seed=6)
    x = x.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        c5.conv5_kl(x.transpose(3, 4), w, b, "stem")
    assert c5.conv5_form(x, 17, "stem") == "stem"
    c5.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        c5._conv5_cuda(x, w, b, "stem", None, form="stem_tc")
    assert c5.LAUNCHES["conv5_stem_tc"] == 0


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


# The bf16 warpgroup kernel (conv5_wg_kernel): (what, [N, D, Ci, H, W], Co).
# A K split at the deep level's width, a grid that needs no split (the
# blocks apply bias and epilogue themselves), Co = 3 (the narrowest wgmma),
# odd H and W in a single depth slice, and a thin plane stacked in depth.
WG_CASES = [("split-256", (2, 8, 256, 8, 8), 256),
            ("unsplit", (2, 40, 16, 32, 64), 32),
            ("co3", (1, 6, 32, 24, 40), 3),
            ("odd-d1", (1, 1, 20, 37, 45), 40),
            ("thin", (1, 12, 32, 3, 5), 64)]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("what,shape,co", WG_CASES,
                         ids=[c[0] for c in WG_CASES])
def test_wg_kernel_matches_plain(dev, what, shape, co, fused):
    x, w, b, ep = _conv_inputs(shape, co, dev, seed=2)
    x = x.to(torch.bfloat16)
    ep = ep if fused else None
    n, d, ci, h, ww = shape
    q = c5.conv5_wg_geometry(n, d, h, ww, ci, co)
    assert (q["splits"] > 1) == (what != "unsplit")
    got = (c5.conv5_kl_fused(x, w, b, ep) if fused else c5.conv5_kl(x, w, b))
    torch.cuda.synchronize()
    _close(got, c5.conv5_kl_plain(x, w, b, ep), torch.bfloat16)


@pytest.mark.parametrize("what,shape,co", WG_CASES,
                         ids=[c[0] for c in WG_CASES])
def test_wg_kernel_dgrad_matches_plain(dev, what, shape, co):
    """The input gradient through the same kernel: Ci = 3 is the head's
    (a 16-channel chunk holding 3)."""
    n, d, ci, h, ww = shape
    _, w, _, _ = _conv_inputs(shape, co, dev, seed=3)
    g = torch.from_numpy(np.random.RandomState(4).randn(
        n, d, co, h, ww).astype(np.float32)).to(dev).to(torch.bfloat16)
    got = c5.conv5_dgrad_kl(g, w)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == torch.bfloat16
    _close(got, c5.conv5_dgrad_kl_plain(g, w), torch.bfloat16)


@pytest.mark.parametrize("what,shape,co", WG_CASES,
                         ids=[c[0] for c in WG_CASES])
def test_wg_kernel_repeats_bit_identically(dev, what, shape, co):
    """No atomics: partials are summed in split order, so two launches on
    the same operands agree bit for bit, forward and input gradient."""
    x, w, b, ep = _conv_inputs(shape, co, dev, seed=5)
    x = x.to(torch.bfloat16)
    first = c5.conv5_kl_fused(x, w, b, ep)
    assert torch.equal(first, c5.conv5_kl_fused(x, w, b, ep))
    g = first.clone()
    dx = c5.conv5_dgrad_kl(g, w)
    assert torch.equal(dx, c5.conv5_dgrad_kl(g, w))


@pytest.mark.parametrize("what", ["strided", "rows-not-16-byte-aligned",
                                  "base-not-16-byte-aligned"])
def test_wg_kernel_takes_any_w_contiguous_view(dev, what):
    """Views the tensor copy cannot describe go through the kernel's scalar
    staging path; a transposed [N, C, D, H, W] tensor goes through the
    tensor copy with its own strides."""
    x, w, b, ep = _conv_inputs((2, 6, 16, 12, 24), 16, dev, seed=6)
    x = x.to(torch.bfloat16)
    if what == "strided":
        view = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "rows-not-16-byte-aligned":  # W = 21: row starts at 42 bytes
        x = x[..., :21].contiguous()
        view = x
    else:  # a base 2 bytes into an allocation
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
    assert torch.equal(view, x)
    got = c5.conv5_kl_fused(view, w, b, ep)
    torch.cuda.synchronize()
    _close(got, c5.conv5_kl_plain(x, w, b, ep), torch.bfloat16)


def test_wg_kernel_packed_weight_follows_the_parameter(dev):
    """The packed weights are kept per parameter and rebuilt after an
    in-place update: the second conv sees the new values."""
    x, w, b, _ = _conv_inputs((1, 4, 16, 8, 16), 16, dev, seed=7)
    x = x.to(torch.bfloat16)
    param = torch.nn.Parameter(w.permute(4, 3, 0, 1, 2).contiguous())
    view = param.permute(2, 3, 4, 1, 0)
    with torch.no_grad():
        first = c5.conv5_kl(x, view, b)
        assert torch.equal(first, c5.conv5_kl(x, param.permute(2, 3, 4, 1, 0),
                                              b))
        param.mul_(-1.0)
        second = c5.conv5_kl(x, param.permute(2, 3, 4, 1, 0), b)
    _close(second, c5.conv5_kl_plain(x, -w, b), torch.bfloat16)
    assert not torch.equal(first, second)


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
    form = c5.conv5_wgrad_form(x, g, kind)
    # bf16 convs take the tensor-copy kernels (square and wide:
    # wgrad_tma_kernel, narrow heads: wgrad_head_tma_kernel), fed by tensor
    # copies on W-aligned views and by their software producer on the
    # ragged ones (W = 100, W = 10, W = 3)
    copyable = (dtype == torch.bfloat16 and kind == "head" and
                shape[4] % 8 == 0)
    # bf16 stems take the tensor-core stem kernel, f32 stems the split-TF32
    # stem kernel; every other f32 conv the split-TF32 kernel (any
    # W-contiguous view)
    assert form == (("stem_tc" if dtype == torch.bfloat16 else "stem_tf32")
                    if kind == "stem" else
                    "tf32" if dtype == torch.float32 else
                    ("head_tma" if copyable else "head_ragged") if co <= 16
                    else ("tma" if copyable else "ragged"))
    assert c5.LAUNCHES["conv5_wgrad_" + form] == 1
    assert sum(c5.LAUNCHES.values()) == 1
    assert got.shape == (5, 5, 5, shape[2], co)
    assert got.dtype == torch.float32
    _scaled_close(got, c5.conv5_wgrad_kl_plain(x, g), dtype)
    # deterministic: no atomics in the voxel reduction
    assert torch.equal(got, c5.conv5_wgrad_kl(x, g, kind))


# The tensor-copy weight-gradient kernel (wgrad_tma_kernel): (what, [N, D,
# Ci, H, W], Co) at Ci = Co in {32, 64, 128, 256} and each tile width (tw
# 32, 16, 8), with split and unsplit voxel axes
TMA_CASES = [("c32-tw32-split", (2, 6, 32, 16, 32), 32),
             ("c64-tw16-split", (1, 6, 64, 12, 16), 64),
             ("c128-tw32", (1, 4, 128, 8, 24), 128),
             ("c256-tw8", (2, 4, 256, 8, 8), 256),
             ("ci40-co48", (1, 3, 40, 6, 24), 48)]


def _wgrad_operands(shape, co, dev, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = torch.from_numpy(rng.randn(*shape[:2], co, *shape[3:]).astype(
        np.float32))
    return x.to(dev).bfloat16(), g.to(dev).bfloat16()


@pytest.mark.parametrize("what,shape,co", TMA_CASES,
                         ids=[c[0] for c in TMA_CASES])
def test_wgrad_tma_kernel_matches_plain_and_repeats(dev, what, shape, co):
    """Against the plain version (scaled bf16 tolerance), bit for bit on a
    second launch (the split partials are summed in a fixed order), and
    counted under its own key."""
    x, g = _wgrad_operands(shape, co, dev, seed=10)
    n, d, ci, h, w = shape
    q = c5.conv5_wgrad_tma_geometry(n, d, h, w, ci, co)
    if "split" in what:
        assert q["splits"] > 1
    c5.reset_launches()
    got = c5.conv5_wgrad_kl(x, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in c5.LAUNCHES.items() if v} == {
        "conv5_wgrad_tma": 1}
    _scaled_close(got, c5.conv5_wgrad_kl_plain(x, g), torch.bfloat16)
    assert torch.equal(got, c5.conv5_wgrad_kl(x, g))


# The narrow head's tensor-copy weight gradient (wgrad_head_tma_kernel):
# (what, [N, D, Ci, H, W], Co) at the V-Net head (32 -> 3), each tile
# width (tw 16, 32; W narrower than a tile), ragged channel counts (two ci
# tiles, several 3-channel co groups, Co = 16, Co = 1), split and unsplit
HEAD_TMA_CASES = [("c32-co3-tw32-split", (2, 6, 32, 16, 32), 3),
                  ("c32-co3-tw16", (1, 3, 32, 8, 16), 3),
                  ("c8-co1-w8", (2, 2, 8, 4, 8), 1),
                  ("ci40-co7", (1, 3, 40, 6, 24), 7),
                  ("c32-co16-h9-w40", (1, 5, 32, 9, 40), 16)]


@pytest.mark.parametrize("what,shape,co", HEAD_TMA_CASES,
                         ids=[c[0] for c in HEAD_TMA_CASES])
def test_wgrad_head_tma_kernel_matches_plain_and_repeats(dev, what, shape,
                                                         co):
    """Against the plain version (scaled bf16 tolerance), bit for bit on a
    second launch (the split partials are summed in a fixed order), and
    counted under its own key."""
    x, g = _wgrad_operands(shape, co, dev, seed=12)
    n, d, ci, h, w = shape
    q = c5.conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co)
    if "split" in what:
        assert q["splits"] > 1
    c5.reset_launches()
    got = c5.conv5_wgrad_kl(x, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in c5.LAUNCHES.items() if v} == {
        "conv5_wgrad_head_tma": 1}
    _scaled_close(got, c5.conv5_wgrad_kl_plain(x, g), torch.bfloat16)
    assert torch.equal(got, c5.conv5_wgrad_kl(x, g))


# The bf16 stem's weight gradient (stem_wgrad_tc_kernel): (what, [N, D, 1,
# H, W], Co) at the stem shapes of the cube (128^3, batch 2) and of the
# flagship (12 x 512 x 512, batch 3), and small ragged ones (W < 16, W not
# a multiple of the tile, D < 5, Co < 16, two depth chunks, several items
# a block)
STEM_WGRAD_CASES = [("cube", (2, 128, 1, 128, 128), 16),
                    ("flagship", (3, 12, 1, 512, 512), 16),
                    ("w7-d3", (1, 3, 1, 5, 7), 16),
                    ("h9-w40-co5", (2, 4, 1, 9, 40), 5),
                    ("chunks", (1, 16, 1, 8, 8), 16),
                    ("items", (4, 8, 1, 128, 200), 16)]


@pytest.mark.parametrize("what,shape,co", STEM_WGRAD_CASES,
                         ids=[c[0] for c in STEM_WGRAD_CASES])
def test_stem_wgrad_tc_kernel_matches_plain_and_repeats(dev, what, shape,
                                                        co):
    """Against the plain version (scaled bf16 tolerance), bit for bit on a
    second launch (the blocks' partials are summed in a fixed order), and
    counted under its own key; the kernel it replaced, forced, agrees."""
    x, g = _wgrad_operands(shape, co, dev, seed=15)
    q = c5.conv5_wgrad_stem_tc_geometry(shape[0], shape[1], *shape[3:])
    if what == "chunks":
        assert q["chunks"] == 2
    if what == "items":
        assert q["per"] > 1
    c5.reset_launches()
    got = c5.conv5_wgrad_kl(x, g, "stem")
    torch.cuda.synchronize()
    assert {k: v for k, v in c5.LAUNCHES.items() if v} == {
        "conv5_wgrad_stem_tc": 1}
    assert got.shape == (5, 5, 5, 1, co) and got.dtype == torch.float32
    ref = c5.conv5_wgrad_kl_plain(x, g)
    _scaled_close(got, ref, torch.bfloat16)
    assert torch.equal(got, c5.conv5_wgrad_kl(x, g, "stem"))
    old = c5._conv5_wgrad_cuda(x, g, "stem", form="stem")
    assert c5.LAUNCHES["conv5_wgrad_stem"] == 1
    _scaled_close(old.to(torch.bfloat16).float(), ref, torch.bfloat16)


def test_stem_wgrad_tc_kernel_reads_strided_views(dev):
    """x as a depth slice of a wider tensor and g from a base 2 bytes into
    an allocation: the kernel reads both by their strides (g by element
    where a row segment is not on 16 bytes)."""
    x, g = _wgrad_operands((1, 6, 1, 9, 40), 16, dev, seed=16)
    wide = torch.zeros((1, 8, 1, 9, 40), dtype=x.dtype, device=dev)
    wide[:, 1:7] = x
    flat = torch.empty(g.numel() + 1, dtype=g.dtype, device=dev)
    view = flat[1:].view(g.shape)
    view.copy_(g)
    c5.reset_launches()
    got = c5.conv5_wgrad_kl(wide[:, 1:7], view, "stem")
    assert c5.LAUNCHES["conv5_wgrad_stem_tc"] == 1
    _scaled_close(got, c5.conv5_wgrad_kl_plain(x, g), torch.bfloat16)


# The f32 stem on the tensor cores in split TF32 (stem_tf32_kernel,
# stem_wgrad_tf32_kernel): (what, [N, D, 1, H, W], Co) at the stem shapes
# of the upstream lung recipe (128^3, batch 2) and spine recipes (512 x 512
# x 12, batch 3), and small ragged ones (W < 16 with D < 5, W over several
# tiles of each kernel, Co < 16, many depth chunks and blocks)
STEM_TF32_CASES = [("cube", (2, 128, 1, 128, 128), 16),
                   ("spine", (3, 512, 1, 512, 12), 16),
                   ("w7-d3", (1, 3, 1, 5, 7), 16),
                   ("h9-w40-co5", (2, 4, 1, 9, 40), 5),
                   ("w200", (1, 6, 1, 11, 200), 16),
                   ("chunks", (1, 40, 1, 8, 12), 16)]


@pytest.mark.parametrize("what,shape,co", STEM_TF32_CASES,
                         ids=[c[0] for c in STEM_TF32_CASES])
def test_stem_tf32_kernels_match_plain_and_repeat(dev, what, shape, co):
    """The f32 stem's forward, fused forward and weight gradient against
    their plain versions (f32 1e-4; dW relative to its magnitude), each
    counted under its own key, bit for bit on a second launch; the kernels
    they replaced, forced, agree."""
    x, w, b, ep = _conv_inputs(shape, co, dev, seed=17)
    g = torch.from_numpy(np.random.RandomState(18).randn(
        *shape[:2], co, *shape[3:]).astype(np.float32)).to(dev)
    assert c5.conv5_form(x, co, "stem") == "stem_tf32"
    assert c5.conv5_wgrad_form(x, g, "stem") == "stem_tf32"
    calls = {"conv5_stem_tf32": (lambda: c5.conv5_kl(x, w, b, "stem"),
                                 lambda: c5.conv5_kl_plain(x, w, b)),
             "conv5_fused_epilogue": (
                 lambda: c5.conv5_kl_fused(x, w, b, ep, "stem"),
                 lambda: c5.conv5_kl_plain(x, w, b, ep)),
             "conv5_wgrad_stem_tf32": (
                 lambda: c5.conv5_wgrad_kl(x, g, "stem"),
                 lambda: c5.conv5_wgrad_kl_plain(x, g))}
    for key, (call, plain) in calls.items():
        c5.reset_launches()
        got = call()
        torch.cuda.synchronize()
        launched = {k: v for k, v in c5.LAUNCHES.items() if v}
        want = {key: 1}
        if key == "conv5_fused_epilogue":
            want["conv5_stem_tf32"] = 1
        assert launched == want
        ref = plain()
        if key == "conv5_wgrad_stem_tf32":
            assert got.shape == (5, 5, 5, 1, co)
            _scaled_close(got, ref, torch.float32)
        else:
            assert got.shape == (*shape[:2], co, *shape[3:])
            _close(got, ref, torch.float32)
        assert torch.equal(got, call())
    _close(c5._conv5_cuda(x, w, b, "stem", ep, form="stem"),
           c5.conv5_kl_plain(x, w, b, ep), torch.float32)
    _scaled_close(c5._conv5_wgrad_cuda(x, g, "stem", form="stem"),
                  c5.conv5_wgrad_kl_plain(x, g), torch.float32)


@pytest.mark.parametrize("what", ["odd-base", "channel-slice", "halo-h",
                                  "w13", "w-slice"])
def test_stem_tf32_kernels_take_views(dev, what):
    """Views the 16-byte copies cannot take or that the mesh hands them: x
    and g from a base 4 bytes into an allocation, x and g channel slices
    of wider tensors, an H block behind a 2-row halo on each side (g
    zero-padded by 2 rows, as the backward pads it), rows of 13, and the
    first 102 columns of rows 104 wide (16-byte copies whose last group
    of a row holds 2 voxels of the view and 2 of the row beyond it)."""
    x, w, b, ep = _conv_inputs((1, 6, 1, 10, 24), 16, dev, seed=19)
    g = torch.randn((1, 6, 16, 10, 24), device=dev)
    if what == "odd-base":
        fx = torch.zeros(x.numel() + 1, device=dev)
        fg = torch.zeros(g.numel() + 1, device=dev)
        fx[1:].copy_(x.reshape(-1))
        fg[1:].copy_(g.reshape(-1))
        x, g = fx[1:].view(x.shape), fg[1:].view(g.shape)
    elif what == "channel-slice":
        x = torch.cat([x, x, x], 2)[:, :, 1:2]
        g = torch.randn((1, 6, 20, 10, 24), device=dev)[:, :, 3:19]
    elif what == "halo-h":
        x = torch.nn.functional.pad(x, (0, 0, 2, 2))
        g = torch.nn.functional.pad(g, (0, 0, 2, 2))
    elif what == "w13":
        x, w, b, ep = _conv_inputs((2, 5, 1, 9, 13), 16, dev, seed=20)
        g = torch.randn((2, 5, 16, 9, 13), device=dev)
    else:
        x, w, b, ep = _conv_inputs((1, 6, 1, 10, 104), 16, dev, seed=22)
        g = torch.randn((1, 6, 16, 10, 104), device=dev)
        x, g = x[..., :102], g[..., :102]
    c5.reset_launches()
    _close(c5.conv5_kl_fused(x, w, b, ep, "stem"),
           c5.conv5_kl_plain(x, w, b, ep), torch.float32)
    _scaled_close(c5.conv5_wgrad_kl(x, g, "stem"),
                  c5.conv5_wgrad_kl_plain(x, g), torch.float32)
    assert (c5.LAUNCHES["conv5_stem_tf32"],
            c5.LAUNCHES["conv5_wgrad_stem_tf32"]) == (1, 1)


def test_stem_tf32_kernels_raise_on_what_they_cannot_take(dev):
    """W not the contiguous axis raises; 17 output channels are the
    CUDA-core kernels' by the gate, and forced onto the split-TF32 stem
    kernels the launches are refused and the wrappers raise; bf16 forced
    onto them raises; nothing falls back."""
    x, w, b, _ = _conv_inputs((1, 4, 1, 8, 16), 17, dev, seed=21)
    g = torch.randn((1, 4, 17, 8, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        c5.conv5_kl(x.transpose(3, 4), w, b, "stem")
    assert c5.conv5_form(x, 17, "stem") == "stem"
    assert c5.conv5_wgrad_form(x, g, "stem") == "stem"
    c5.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        c5._conv5_cuda(x, w, b, "stem", None, form="stem_tf32")
    with pytest.raises(RuntimeError, match="launch failed"):
        c5._conv5_wgrad_cuda(x, g, "stem", form="stem_tf32")
    with pytest.raises(TypeError, match="float32"):
        c5._conv5_cuda(x.bfloat16(), w[..., :16], b[:16], "stem", None,
                       form="stem_tf32")
    assert c5.LAUNCHES["conv5_stem_tf32"] == 0
    assert c5.LAUNCHES["conv5_wgrad_stem_tf32"] == 0


def test_wgrad_head_tma_kernel_raises_on_a_view_it_cannot_take(dev):
    """A base 2 bytes into an allocation is not a view a tensor copy can
    describe: the gate sends it to the software producer of
    wgrad_head_tma_kernel, and forced onto the tensor copy the launch is
    refused and the wrapper raises; nothing falls back to the plain
    version."""
    x, g = _wgrad_operands((1, 3, 32, 8, 16), 3, dev, seed=13)
    flat = torch.empty(g.numel() + 1, dtype=g.dtype, device=dev)
    view = flat[1:].view(g.shape)
    view.copy_(g)
    assert c5.conv5_wgrad_form(x, view, "head") == "head_ragged"
    c5.reset_launches()
    _scaled_close(c5.conv5_wgrad_kl(x, view), c5.conv5_wgrad_kl_plain(
        x, view), torch.bfloat16)
    assert c5.LAUNCHES["conv5_wgrad_head_ragged"] == 1
    with pytest.raises(RuntimeError, match="launch failed"):
        c5._conv5_wgrad_cuda(x, view, "head", form="head_tma")
    assert c5.LAUNCHES["conv5_wgrad_head_tma"] == 0


@pytest.mark.parametrize("what", ["ncdhw-view", "g-view", "unaligned-base",
                                  "rows-not-16-byte-aligned"])
def test_wgrad_tma_kernel_views(dev, what):
    """A transposed [N, C, D, H, W] tensor is a view the tensor copy can
    describe (its own strides, no copy); a base 2 bytes into an allocation
    or W = 20 is not, and goes to the kernel's software producer. Both
    agree with the plain version."""
    x, g = _wgrad_operands((2, 5, 32, 8, 24), 64, dev, seed=11)
    if what == "ncdhw-view":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "g-view":
        g = g.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "unaligned-base":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        x = view
    else:
        x, g = x[..., :20].contiguous(), g[..., :20].contiguous()
    want = "tma" if what.endswith("view") else "ragged"
    assert c5.conv5_wgrad_form(x, g, "head") == want
    c5.reset_launches()
    got = c5.conv5_wgrad_kl(x, g)
    torch.cuda.synchronize()
    assert c5.LAUNCHES["conv5_wgrad_" + want] == 1
    _scaled_close(got, c5.conv5_wgrad_kl_plain(x, g), torch.bfloat16)


# The tensor-copy kernels' software producer ('ragged', 'head_ragged') on
# views a tensor copy cannot describe: (what, [N, D, Ci, H, W], Co, view)
# at W = 9, 12, 4 and 2 (realigned loads, cp.async of 8 and 4 bytes), Co 20
# and 3, a base 2 bytes into an allocation, a channel slice, W over several
# tiles
RAGGED_CASES = [("w9-co20", (2, 5, 40, 9, 9), 20, None),
                ("w12-co20", (2, 5, 32, 9, 12), 20, None),
                ("w4-co40", (2, 6, 36, 8, 4), 40, None),
                ("w2-co20", (2, 6, 32, 8, 2), 20, None),
                ("w9-co3", (2, 5, 32, 9, 9), 3, None),
                ("w12-co3", (2, 5, 40, 9, 12), 3, None),
                ("w4-co3", (2, 6, 32, 8, 4), 3, None),
                ("w2-co16", (2, 6, 32, 8, 2), 16, None),
                ("w100-co36", (1, 3, 24, 7, 100), 36, None),
                ("odd-base-co20", (2, 4, 32, 8, 16), 20, "odd"),
                ("odd-base-co3", (2, 4, 32, 8, 16), 3, "odd"),
                ("channel-slice-co20", (2, 4, 32, 8, 12), 20, "slice"),
                ("channel-slice-co3", (2, 4, 32, 8, 12), 3, "slice")]


def _ragged_view(x, how):
    """``x`` as the view ``how`` names, same values: a base 2 bytes into
    an allocation, or channels 3.. of a wider tensor."""
    if how == "odd":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = flat[1:].view(x.shape)
    elif how == "slice":
        n, d, c, h, w = x.shape
        view = torch.empty((n, d, c + 7, h, w), dtype=x.dtype,
                           device=x.device)[:, :, 3:3 + c]
    else:
        return x
    view.copy_(x)
    return view


@pytest.mark.parametrize("what,shape,co,how", RAGGED_CASES,
                         ids=[c[0] for c in RAGGED_CASES])
def test_wgrad_ragged_matches_plain_and_the_tensor_copy(dev, what, shape, co,
                                                        how):
    """Against the plain version (scaled bf16 tolerance); bit for bit on a
    second launch; and bit for bit the tensor copy's route on the same
    values padded to a W that is a multiple of 8 (the producer fills the
    same boxes, byte for byte)."""
    x, g = _wgrad_operands(shape, co, dev, seed=len(what))
    x = _ragged_view(x, how)
    if how == "odd":
        g = _ragged_view(g, how)
    form = "ragged" if co > 16 else "head_ragged"
    assert c5.conv5_wgrad_form(x, g, "head") == form
    c5.reset_launches()
    got = c5._conv5_wgrad_cuda(x, g, "head")
    torch.cuda.synchronize()
    assert c5.LAUNCHES["conv5_wgrad_" + form] == 1
    assert sum(c5.LAUNCHES.values()) == 1
    _scaled_close(got, c5.conv5_wgrad_kl_plain(x, g), torch.bfloat16)
    assert torch.equal(got, c5._conv5_wgrad_cuda(x, g, "head"))
    xp, gp = padded(x), padded(g)
    assert c5.conv5_wgrad_form(xp, gp, "head") == form.replace("ragged",
                                                               "tma")
    assert torch.equal(got, c5._conv5_wgrad_cuda(xp, gp, "head"))


@pytest.mark.parametrize("co", [32, 3])
def test_wgrad_ragged_equals_the_tensor_copy_on_a_view_both_take(dev, co):
    """Forced onto a contiguous W = 16 view, the software producer gives
    the tensor copy's bits."""
    x, g = _wgrad_operands((2, 5, 40, 9, 16), co, dev, seed=co)
    tma, ragged = ("tma", "ragged") if co > 16 else ("head_tma",
                                                     "head_ragged")
    assert c5.conv5_wgrad_form(x, g, "head") == tma
    assert torch.equal(c5._conv5_wgrad_cuda(x, g, "head", form=ragged),
                       c5._conv5_wgrad_cuda(x, g, "head"))


def test_wgrad_ragged_raises_on_views_it_cannot_take(dev):
    """W not the contiguous axis, or f32 forced onto the bf16 producer:
    the wrapper raises; nothing falls back to another kernel or to the
    plain version."""
    x, g = _wgrad_operands((2, 5, 32, 9, 9), 20, dev, seed=3)
    xt = x.transpose(3, 4).contiguous().transpose(3, 4)
    c5.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        c5.conv5_wgrad_kl(xt, g)
    with pytest.raises(TypeError, match="bf16"):
        c5._conv5_wgrad_cuda(x.float(), g.float(), "head", form="ragged")
    assert sum(c5.LAUNCHES.values()) == 0


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
    key = "conv5_dgrad" if dtype == torch.bfloat16 else "conv5_dgrad_tf32"
    assert c5.LAUNCHES[key] == 1 and c5.LAUNCHES["conv5_head"] == 0
    assert got.shape == shape and got.dtype == dtype
    _close(got, c5.conv5_dgrad_kl_plain(g, w), dtype)


# The split-TF32 f32 kernels (conv5_tf32_kernel, wgrad_tf32_kernel): (what,
# [N, D, Ci, H, W], Co) at two cube shapes (the deep level, whose forward
# splits K, and up_tr128 at 32^3) and an odd shape with ragged H and W (not
# multiples of the tiles), Ci not a multiple of 8 and Co 20 (24 columns)
TF32_CASES = [("cube-256-8", (2, 8, 256, 8, 8), 256),
              ("cube-128-32", (2, 32, 128, 32, 32), 128),
              ("odd-h13-w45", (1, 5, 12, 13, 45), 20)]


@pytest.mark.parametrize("what,shape,co", TF32_CASES,
                         ids=[c[0] for c in TF32_CASES])
def test_tf32_kernels_match_plain_and_repeat(dev, what, shape, co):
    """The forward, the fused forward, the input gradient and the weight
    gradient of an f32 head conv against their plain versions (f32 1e-4;
    dW relative to its magnitude), each counted under its own key, and
    bit for bit on a second launch."""
    x, w, b, ep = _conv_inputs(shape, co, dev, seed=12)
    g = torch.from_numpy(np.random.RandomState(13).randn(
        *shape[:2], co, *shape[3:]).astype(np.float32)).to(dev)
    calls = {"conv5_head_tf32": lambda: c5.conv5_kl(x, w, b),
             "conv5_fused_epilogue": lambda: c5.conv5_kl_fused(x, w, b, ep),
             "conv5_dgrad_tf32": lambda: c5.conv5_dgrad_kl(g, w),
             "conv5_wgrad_tf32": lambda: c5.conv5_wgrad_kl(x, g)}
    refs = {"conv5_head_tf32": lambda: c5.conv5_kl_plain(x, w, b),
            "conv5_fused_epilogue": lambda: c5.conv5_kl_plain(x, w, b, ep),
            "conv5_dgrad_tf32": lambda: c5.conv5_dgrad_kl_plain(g, w),
            "conv5_wgrad_tf32": lambda: c5.conv5_wgrad_kl_plain(x, g)}
    for key, call in calls.items():
        c5.reset_launches()
        got = call()
        torch.cuda.synchronize()
        launched = {k: v for k, v in c5.LAUNCHES.items() if v}
        if key == "conv5_fused_epilogue":
            assert launched == {"conv5_head_tf32": 1, key: 1}
        else:
            assert launched == {key: 1}
        ref = refs[key]()
        if key == "conv5_wgrad_tf32":
            _scaled_close(got, ref, torch.float32)
        else:
            _close(got, ref, torch.float32)
        assert torch.equal(got, call())


def test_tf32_kernels_take_ragged_views(dev):
    """Views the 16-byte paths of the bf16 kernels cannot take (a base 4
    bytes into an allocation, W = 13 rows, a channel slice) through the
    4-byte staging of the split-TF32 kernels."""
    x, w, b, _ = _conv_inputs((1, 4, 8, 9, 13), 8, dev, seed=14)
    flat = torch.zeros(x.numel() + 1, device=dev)
    flat[1:].copy_(x.reshape(-1))
    xv = flat[1:].view(x.shape)
    wide = torch.randn((1, 4, 12, 9, 13), device=dev)
    g = wide[:, :, 2:10]
    _close(c5.conv5_kl(xv, w, b), c5.conv5_kl_plain(x, w, b), torch.float32)
    _close(c5.conv5_dgrad_kl(g, w), c5.conv5_dgrad_kl_plain(g, w),
           torch.float32)
    _scaled_close(c5.conv5_wgrad_kl(xv, g), c5.conv5_wgrad_kl_plain(x, g),
                  torch.float32)


def test_conv5_function_backward_on_the_card(dev):
    """conv5_kl's autograd Function on CUDA tensors: dx, dw and db through
    the kernels against autograd of F.conv3d (f32, TF32 off); a
    non-contiguous cotangent is pinned; the stem skips dx."""
    x, w, b, _ = _conv_inputs((2, 5, 6, 9, 12), 7, dev, seed=8)
    g = torch.randn((2, 5, 7, 12, 9), device=dev).transpose(3, 4)
    xa, wa, ba = (t.clone().requires_grad_(True) for t in (x, w, b))
    c5.reset_launches()
    c5.conv5_kl(xa, wa, ba).backward(g)
    assert c5.LAUNCHES["conv5_dgrad_tf32"] == 1 and c5.LAUNCHES["pin"] == 1
    assert c5.LAUNCHES["conv5_wgrad_tf32"] == 1
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
    assert c5.LAUNCHES["conv5_wgrad_stem_tf32"] == 1
    with pytest.raises(RuntimeError, match="no backward"):
        c5.conv5_kl_fused(xs, ws, b, (b, b, b), "stem")


def test_launch_counts_one_per_kernel_launch(dev):
    x, w, b, ep = _conv_inputs((1, 4, 16, 8, 16), 8, dev, seed=2)
    c5.reset_launches()
    c5.conv5_kl(x.bfloat16(), w, b)
    c5.conv5_kl_fused(x, w, b, ep)
    c5.conv5_kl_fused(x[:, :, :1].contiguous(), w[:, :, :, :1], b, ep,
                      kind="stem")
    xs = x[:, :, :1].bfloat16()
    c5.conv5_kl(xs, w[:, :, :, :1], b, "stem")
    c5.conv5_kl_fused(xs, w[:, :, :, :1], b, ep, kind="stem")
    c5.pin_kl(x)  # contiguous: no copy, no launch
    c5.pin_kl(x.transpose(1, 2))
    xb, gb = x.bfloat16(), torch.randn((1, 4, 3, 8, 16), device=dev).bfloat16()
    c5.conv5_wgrad_kl(xb, gb)
    assert {k: v for k, v in c5.LAUNCHES.items() if v} == {
        "conv5_head": 1, "conv5_head_tf32": 1, "conv5_stem_tf32": 1,
        "conv5_stem_tc": 2, "conv5_fused_epilogue": 3, "pin": 1,
        "conv5_wgrad_head_tma": 1}


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("what,c,e", [("128-byte-runs", 256, 8),
                                      ("plane-runs", 16, 32),
                                      ("misaligned-base", 32, 8)])
def test_pin_16_byte_path_and_its_exits(dev, what, c, e, dtype):
    """[N, C, D, H, W] seen as [N, D, C, H, W]: the (H, W) plane is one
    contiguous run (128 bytes at 8^3 in bf16) and goes as 16-byte words;
    a base that is not 16-byte aligned goes element by element."""
    gen = torch.Generator(device=dev).manual_seed(5)
    numel = 2 * c * e ** 3
    flat = torch.randn((numel + 8,), generator=gen, device=dev).to(dtype)
    off = 1 if what == "misaligned-base" else 0
    view = flat[off:off + numel].view(2, c, e, e, e).transpose(1, 2)
    plan = c5.pin_plan(tuple(view.shape), view.stride(), view.element_size(),
                       view.data_ptr())
    assert plan["path"] == ("element" if off else "vec16")
    assert plan["run"] == e * e
    before = c5.LAUNCHES["pin"]
    got = c5.pin_kl(view)
    torch.cuda.synchronize()
    assert c5.LAUNCHES["pin"] == before + 1
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
    monkeypatch.setattr(c5, "_pin_cuda", c5.pin_kl_plain)  # the pin op's


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
        "conv5_head_tf32": 15, "conv5_stem_tf32": 1,
        "conv5_fused_epilogue": 16, "pin": 8}
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
    f32 = dtype == torch.float32
    assert c5.LAUNCHES["conv5_head_tf32" if f32 else "conv5_head"] == \
        15 * fwd
    # the stem: stem_tc_kernel in bf16, stem_tf32_kernel in f32
    stem = "conv5_stem_tc" if dtype == torch.bfloat16 else "conv5_stem_tf32"
    assert (c5.LAUNCHES[stem], c5.LAUNCHES["conv5_stem"] +
            c5.LAUNCHES["conv5_stem_tc"] +
            c5.LAUNCHES["conv5_stem_tf32"]) == (fwd, fwd)
    assert c5.LAUNCHES["conv5_dgrad_tf32" if f32 else "conv5_dgrad"] == 15
    # the 14 square and wide weight gradients: in bf16 the tensor-copy
    # kernel, fed by tensor copies where W is a multiple of 8 (7 convs at
    # 32, 16 and 8 at this input; all 14 at 128^3) and by its software
    # producer at W = 4 and 2; in f32, with the narrow head, the
    # split-TF32 kernel
    # the narrow head: its tensor-copy kernel in bf16 (W = 32)
    # the stem: stem_wgrad_tc_kernel in bf16, stem_wgrad_tf32_kernel in f32
    wide = (0, 0) if f32 else (7, 7)
    head = (0, 0) if f32 else (0, 1)
    stem = (0, 0, 1) if f32 else (0, 1, 0)
    assert (c5.LAUNCHES["conv5_wgrad_stem"],
            c5.LAUNCHES["conv5_wgrad_stem_tc"],
            c5.LAUNCHES["conv5_wgrad_stem_tf32"],
            c5.LAUNCHES["conv5_wgrad_head_ragged"],
            c5.LAUNCHES["conv5_wgrad_head_tma"],
            c5.LAUNCHES["conv5_wgrad_ragged"],
            c5.LAUNCHES["conv5_wgrad_tma"]) == stem + head + wide
    assert c5.LAUNCHES["conv5_wgrad_head"] == c5.LAUNCHES[
        "conv5_wgrad_mid"] == 0
    assert c5.LAUNCHES["conv5_wgrad_tf32"] == (15 if f32 else 0)
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


def test_library_ops_and_an_exported_program_on_the_card(dev, tmp_path):
    """The ``torch.library`` ops on CUDA tensors pass ``opcheck`` (their
    fake implementations against the kernels' outputs), and a V-Net
    exported on the card launches the hand kernels (at 32^3: 15 head and
    1 stem conv, all fused, and 8 pins) and gives the module's logits bit
    for bit."""
    from medicalseg_torch import export
    x, w, b, ep = _conv_inputs((1, 4, 16, 8, 16), 8, dev, seed=7)
    xb = x.bfloat16()
    for args in ((xb, w, b, *ep, "head"),
                 (xb[:, :, :1].contiguous(), w[:, :, :, :1], b, *ep,
                  "stem")):
        result = torch.library.opcheck(
            torch.ops.medicalseg.conv5_fused.default, args)
        assert set(result.values()) == {"SUCCESS"}
    result = torch.library.opcheck(torch.ops.medicalseg.pin.default,
                                   (xb.transpose(1, 2),))
    assert set(result.values()) == {"SUCCESS"}

    gen = torch.Generator().manual_seed(8)
    model = VNet(num_classes=3, generator=gen).to(dev).eval()
    vol = torch.rand((2, 32, 32, 32, 1), generator=gen).to(dev)
    export.export_program(
        export.SavedSegmentationNet(model, with_argmax=False), vol,
        str(tmp_path / "model.pt2"))
    module = torch.export.load(str(tmp_path / "model.pt2")).module()
    c5.reset_launches()
    with torch.inference_mode():
        got = module(vol)
        launches = {k: v for k, v in c5.LAUNCHES.items() if v}
        ref = model(vol)[0]
    assert launches == {"conv5_head_tf32": 15, "conv5_stem_tf32": 1,
                        "conv5_fused_epilogue": 16, "pin": 8}
    assert torch.equal(got, ref)


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


# ----------------------------------------------------------------------
# HU window + D resize (csrc/hu_resize.cu)
# ----------------------------------------------------------------------
def _raw_ct(seed, shape):
    """Uniform in [-2000, 1000] with a NaN, a +inf and a -inf in every
    hundred voxels or so."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2000, 1000, shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.randint(0, flat.size, 3 * max(1, flat.size // 100))
    flat[idx[0::3]], flat[idx[1::3]], flat[idx[2::3]] = (np.nan, np.inf,
                                                         -np.inf)
    return x


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(d=st.integers(1, 40), out_d=st.integers(1, 40),
       h=st.integers(1, 33), w=st.integers(1, 70),
       hu_nan=st.sampled_from([-2000.0, -300.0, 600.0]))
@example(d=1, out_d=5, h=7, w=9, hu_nan=-2000.0)      # D == 1
@example(d=9, out_d=1, h=5, w=3, hu_nan=-300.0)       # out_d == 1
@example(d=16, out_d=16, h=16, w=16, hu_nan=-300.0)   # identity matrix
@example(d=37, out_d=16, h=45, w=51, hu_nan=-300.0)   # odd H * W
@example(d=3, out_d=7, h=1, w=1, hu_nan=0.0)          # one column
@example(d=40, out_d=25, h=64, w=64, hu_nan=-2000.0)  # 16-byte path
def test_hu_resize_kernel_matches_plain(dev, d, out_d, h, w, hu_nan):
    """1e-3 on the window's 0..255 scale (measured: 3e-5, the order of two
    f32 products)."""
    x = torch.from_numpy(_raw_ct(d * 1000 + h * w, (d, h, w))).to(dev)
    before = hr.LAUNCHES["hu_resize"]
    got = hr.hu_resize_d(x, out_d, -1000.0, 400.0, hu_nan)
    torch.cuda.synchronize()
    assert hr.LAUNCHES["hu_resize"] == before + 1
    assert got.shape == (out_d, h, w) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    ref = hr.hu_resize_d_plain(x, resize._linear_matrix(d, out_d, device=dev),
                               -1000.0, 400.0, hu_nan)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    cpu = hr.hu_resize_d(x.cpu(), out_d, -1000.0, 400.0, hu_nan)
    torch.testing.assert_close(got.cpu(), cpu, atol=1e-3, rtol=0)


def test_hu_resize_casts_and_takes_any_strides(dev):
    raw = np.nan_to_num(_raw_ct(5, (12, 10, 6)), posinf=900, neginf=-1900)
    ints = torch.from_numpy(raw.astype(np.int16)).to(dev)
    strided = torch.from_numpy(raw).to(dev).permute(2, 0, 1)
    assert not strided.is_contiguous()
    for x, out_d in ((ints, 7), (strided, 9)):
        got = hr.hu_resize_d(x, out_d)
        ref = hr.hu_resize_d_plain(
            x.float().contiguous(),
            resize._linear_matrix(x.shape[0], out_d, device=dev))
        torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


def test_hu_norm_resize_on_the_card_is_the_composition(dev):
    x = torch.from_numpy(_raw_ct(6, (23, 40, 36))).to(dev)
    hr.reset_launches()
    got = hr.hu_norm_resize(x, (16, 16, 16), hu_nan=-300.0)
    assert hr.LAUNCHES["hu_resize"] == 1 and got.device.type == "cuda"
    ref = resize.resize3d(intensity.hu_norm(x, hu_nan=-300.0), (16, 16, 16))
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    cpu = hr.hu_norm_resize(x.cpu(), (16, 16, 16), hu_nan=-300.0)
    assert hr.LAUNCHES["hu_resize"] == 1  # a CPU tensor: the plain version
    torch.testing.assert_close(got.cpu(), cpu, atol=1e-3, rtol=0)


def test_hu_resize_cuda_input_never_takes_the_plain_version(dev,
                                                            monkeypatch):
    """With the launch failing, the wrapper raises: it does not hand a
    CUDA tensor to the plain version."""
    x = torch.zeros((4, 4, 4), device=dev)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    class Refused:
        @staticmethod
        def hu_resize_launch(*args):
            return 1

    monkeypatch.setattr(hr, "hu_resize_d_plain", plain)
    assert hr.hu_resize_d(x, 2).device.type == "cuda"
    monkeypatch.setattr(hr, "_lib", lambda: Refused)
    before = hr.LAUNCHES["hu_resize"]
    with pytest.raises(RuntimeError, match="launch failed"):
        hr.hu_resize_d(x, 2)
    assert hr.LAUNCHES["hu_resize"] == before


def test_predictor_serves_a_raw_scan_on_the_card(dev, tmp_path):
    from medicalseg_torch import io as medio
    model_cfg = {"type": "VNet", "num_classes": 2, "dtype": "bfloat16"}
    gen = torch.Generator().manual_seed(6)
    torch.save(VNet(num_classes=2, generator=gen).state_dict(),
               tmp_path / "model.pt")
    (tmp_path / "deploy.yaml").write_text(yaml.dump({"Deploy": {
        "model": "model.stablehlo", "params": "model.pt", "transforms": [],
        "output_op": "argmax", "input_shape_ndhwc": [1, 16, 16, 16, 1],
        "shape_buckets": [], "model_config": model_cfg}}))
    scan = str(tmp_path / "scan.nii.gz")
    medio.write_image(scan, _raw_ct(7, (20, 24, 28)))

    def predictor(*extra):
        return infer.Predictor(infer.parse_args([
            "--config", str(tmp_path / "deploy.yaml"), "--image_path", scan,
            "--save_dir", str(tmp_path / "pred"), *extra]))

    hr.reset_launches()
    pred = predictor()
    x = pred._preprocess(scan)
    assert x.device.type == "cuda" and tuple(x.shape) == (1, 16, 16, 16, 1)
    assert hr.LAUNCHES["hu_resize"] == 1
    out = np.load(pred.run([scan])[0])
    assert out.shape == (16, 16, 16) and hr.LAUNCHES["hu_resize"] == 2
    out = np.load(predictor("--use_swl", "true").run([scan])[0])
    assert out.shape == (20, 24, 28) and hr.LAUNCHES["hu_resize"] == 2
    q = predictor("--precision", "int8")
    assert all(t.device.type == "cuda" for t in q._qstate.values())
    assert q._qstate["in_tr.conv1.weight.__quant__"].dtype == torch.int8
    agree = (np.load(q.run([scan])[0]) == np.load(pred.run([scan])[0])).mean()
    assert agree >= 0.9


def _val_set(root, classes, edge, n, seed):
    """``n`` seeded volumes of ``edge``^3 and labels in [0, classes) as a
    val MedicalDataset."""
    from medicalseg_torch.datasets import MedicalDataset
    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    lines = []
    for i in range(n):
        np.save(root / "images" / "v{}.npy".format(i),
                rng.rand(edge, edge, edge).astype(np.float32))
        np.save(root / "labels" / "v{}.npy".format(i),
                rng.randint(0, classes, (edge,) * 3).astype(np.uint8))
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    (root / "val_list.txt").write_text("".join(lines))
    return MedicalDataset(str(root), str(root), [], classes, mode="val")


def test_evaluate_on_the_card_matches_the_cpu(dev, tmp_path):
    """``core.val.evaluate`` of an f32 V-Net (non-trivial BN statistics) on
    two 32^3 volumes: on the card, through the fused-epilogue forward and
    the pins, against the port's CPU evaluate (the plain versions). The
    logits agree to 2e-4, so the soft numbers to 1e-4 and the argmax ones
    to 1e-3 (a few of 65536 voxels may flip at near ties); the dumped
    predictions agree on >= 99.5% of voxels."""
    import copy

    from medicalseg_torch.core.val import evaluate
    ds = _val_set(tmp_path / "data", 3, 32, 2, seed=8)
    gen = torch.Generator().manual_seed(5)
    model = VNet(num_classes=3, generator=gen)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
        else:
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    losses = {"types": [MixedLoss([CrossEntropyLoss(), DiceLoss()], [1, 1])],
              "coef": [1]}
    cpu = TrainState(copy.deepcopy(model), None, None, None)
    card = TrainState(model.to(dev), None, None, None)
    c5.reset_launches()
    got = evaluate(card, ds, losses, auc_roc=True,
                   save_dir=str(tmp_path / "card"))
    launches = dict(c5.LAUNCHES)
    want = evaluate(cpu, ds, losses, auc_roc=True,
                    save_dir=str(tmp_path / "cpu"))
    assert launches["conv5_fused_epilogue"] == 2 * 16
    assert launches["pin"] == 2 * 8
    for key, tol in (("mdice", 1e-4), ("auc_roc", 1e-4),
                     ("mdice_hard", 1e-3)):
        assert abs(got[key] - want[key]) <= tol, key
    for i in range(2):
        a = np.load(tmp_path / "card" / str(i) / "pred.npy")
        b = np.load(tmp_path / "cpu" / str(i) / "pred.npy")
        assert a.shape == (32, 32, 32) and (a == b).mean() >= 0.995


@pytest.mark.parametrize("name", ["ce", "dice-sigmoid", "dice-softmax",
                                  "mixed"])
def test_fused_losses_on_the_card_match_the_loop_form(dev, monkeypatch,
                                                      name):
    """At the flagship's 20 classes, with ignored voxels and labels outside
    [0, 20): the default (fused) form's value and logits gradient against
    the loop form's, on the card (rtol 1e-5; the fused sums add by
    atomics, in no fixed order)."""
    from medicalseg_torch.utils.loss_utils import loss_computation
    rng = np.random.RandomState(11)
    shape = (2, 8, 64, 64)
    logits = torch.from_numpy(
        (2 * rng.randn(*shape, 20)).astype(np.float32)).to(dev)
    labels = rng.randint(0, 20, shape)
    labels[rng.rand(*shape) < 0.1] = 255
    labels[rng.rand(*shape) < 0.02] = 23
    labels = torch.from_numpy(labels).to(dev)
    fn = {"ce": CrossEntropyLoss(),
          "dice-sigmoid": lambda l, y: DiceLoss()(l, y)[0],
          "dice-softmax": lambda l, y: DiceLoss(sigmoid_norm=False)(l, y)[0],
          "mixed": lambda l, y: sum(loss_computation([l], y, {
              "types": [MixedLoss([CrossEntropyLoss(), DiceLoss()], [1, 1])],
              "coef": [1]})[0])}[name]

    def run(fused):
        monkeypatch.setenv("MEDSEG_LOSS_FUSED", fused)
        t = logits.clone().requires_grad_(True)
        value = fn(t, labels)
        value.backward()
        return value.item(), t.grad

    (fused, fused_grad), (loop, loop_grad) = run("1"), run("0")
    assert fused == pytest.approx(loop, rel=1e-5)
    scale = loop_grad.abs().max().item()
    torch.testing.assert_close(fused_grad, loop_grad, rtol=1e-5,
                               atol=1e-6 * scale)


# --------------------------------------------------------------------------
# the graphed step (core.state.GraphedStep through make_cached_train_step
# and make_multi_step) and the optimizers a graph can replay
# --------------------------------------------------------------------------
def _graph_trainer(dtype=torch.bfloat16, remat=True, dropout=True):
    from medicalseg_torch.cvlibs.config import polynomial_decay
    model = VNet(num_classes=3, dtype=dtype, remat=remat, dropout=dropout,
                 generator=torch.Generator().manual_seed(8))
    return TrainState.create(
        model, lambda p: torch.optim.SGD(p, lr=0.01, momentum=0.9,
                                         weight_decay=1e-4),
        polynomial_decay(0.01, 20), seed=9, capturable_optimizer=True)


def _graph_losses():
    return {"types": [MixedLoss([CrossEntropyLoss(), DiceLoss()], [1, 1])],
            "coef": [1]}


def _first_mask(model):
    from medicalseg_torch.models.layers import ChannelDropout
    return next(m for m in model.modules()
                if isinstance(m, ChannelDropout))._keep.clone()


@pytest.mark.parametrize("dtype,remat", [(torch.float32, False),
                                         (torch.bfloat16, True)],
                         ids=["f32", "bf16-remat"])
def test_graphed_cached_step_is_the_eager_step(dev, dtype, remat):
    """Five steps over a dataset cached on the card: the eager step and the
    cached step (its first call the warm-up and the capture, then four
    replays of one CUDA graph) from one state, re-seeded from (seed, step)
    alike. Every kernel of the step is deterministic, so the losses, the
    parameters, the BatchNorm statistics and the dropout masks agree bit
    for bit, and so do eval-mode logits taken between steps (they read
    the conv kernels' packed weights, which a replay must not leave
    stale); the parameters move at every replay; a replay launches the
    hand kernels one eager step launches."""

    def probe(state):
        with torch.no_grad():
            out = state.model.eval()(cache[0][:1])[0]
        state.model.train()
        return out

    from medicalseg_torch.core.state import make_cached_train_step
    from medicalseg_torch.transforms.device import step_seed
    rng = np.random.RandomState(7)
    cache = (torch.from_numpy(rng.rand(4, 32, 32, 32, 1).astype(
        np.float32)).to(dev), torch.from_numpy(rng.randint(
            0, 3, (4, 32, 32, 32)).astype(np.uint8)).to(dev))
    stream = rng.randint(0, 4, (5, 2)).astype(np.int32)
    eager, graphed = _graph_trainer(dtype, remat), _graph_trainer(dtype,
                                                                   remat)
    step = make_train_step(_graph_losses())
    c5.reset_launches()
    e_loss, e_mask, e_probe = [], [], []
    for idx in stream:
        eager.generator.manual_seed(step_seed(3, eager.step))
        i = torch.from_numpy(idx).long().to(dev)
        _, m = step(eager, cache[0][i], cache[1][i])
        e_loss.append(m["loss"].item())
        e_mask.append(_first_mask(eager.model))
    per_step = {k: v // 5 for k, v in c5.LAUNCHES.items()}
    eager = _graph_trainer(dtype, remat)
    for idx in stream:  # again, with an evaluation after every step
        eager.generator.manual_seed(step_seed(3, eager.step))
        i = torch.from_numpy(idx).long().to(dev)
        step(eager, cache[0][i], cache[1][i])
        e_probe.append(probe(eager))
    cached = make_cached_train_step(_graph_losses())
    g_loss, g_mask, g_probe, snapshots = [], [], [], []
    for idx in stream:
        _, m = cached(graphed, *cache, idx, seed=3)
        g_loss.append(m["loss"].item())
        g_mask.append(_first_mask(graphed.model))
        g_probe.append(probe(graphed))
        snapshots.append(graphed.model.in_tr.conv1.weight.detach().clone())
    assert cached.graphed.replays == 4 and graphed.step == 5
    assert cached.graphed.launches == per_step
    assert g_loss == e_loss
    for a, b in zip(g_probe, e_probe):
        assert torch.equal(a, b)
    for a, b in zip(snapshots[1:], snapshots[:-1]):
        assert not torch.equal(a, b)  # the parameters move at each replay
    for a, b in zip(g_mask[1:], e_mask[1:]):  # step 1 was the capture's
        assert torch.equal(a, b)
    assert not torch.equal(g_mask[1], g_mask[2])
    want = eager.model.state_dict()
    for k, v in graphed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for p, q in zip(graphed.model.parameters(), eager.model.parameters()):
        assert torch.equal(graphed.optimizer.state[p]["momentum_buffer"],
                           eager.optimizer.state[q]["momentum_buffer"])


def test_graphed_multi_step_reseeds_and_refuses_an_eager_optimizer(dev):
    """A super-batch of three steps: three replays of one graph, metrics
    stacked along [3]; a replay re-seeded as an earlier step was draws
    that step's dropout mask again. An optimizer that keeps its learning
    rate on the host cannot be captured: the step raises rather than run
    eagerly."""
    from medicalseg_torch.core.state import make_multi_step
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.rand(3, 2, 32, 32, 32, 1).astype(
        np.float32)).to(dev)
    labels = torch.from_numpy(rng.randint(0, 3, (3, 2, 32, 32, 32)).astype(
        np.uint8)).to(dev)
    state = _graph_trainer()
    multi = make_multi_step(_graph_losses(), 3)
    _, m = multi(state, images, labels, seed=5)
    assert m["loss"].shape == (3,) and torch.isfinite(m["loss"]).all()
    assert multi.graphed.replays == 2 and state.step == 3
    mask = _first_mask(state.model)
    state.step = 2
    multi(state, images[2:], labels[2:], seed=5)
    assert torch.equal(_first_mask(state.model), mask)
    model = VNet(num_classes=3, generator=torch.Generator().manual_seed(8))
    eager_opt = TrainState.create(
        model, lambda p: torch.optim.SGD(p, lr=0.01, momentum=0.9),
        lambda step: 0.01, seed=9)
    with pytest.raises(ValueError, match="capturable_optimizer"):
        make_multi_step(_graph_losses(), 3)(eager_opt, images, labels)


@pytest.mark.parametrize("kind", ["sgd", "nesterov", "adam", "adamw",
                                  "rmsprop"])
def test_capturable_optimizers_replay_as_torch_steps_eagerly(dev, kind):
    """Each optimizer's capturable form, its step captured once and
    replayed for 20 updates with the learning rate written into its tensor
    between replays, against the eager torch (and, for RMSProp, the
    port's) optimizer with a float learning rate (f32; 1e-5 for 20
    updates of O(1) entries)."""
    from medicalseg_torch.cvlibs.config import RMSProp, capturable, set_lr
    make = {
        "sgd": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9,
                                         weight_decay=1e-2),
        "nesterov": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.8,
                                              nesterov=True),
        "adam": lambda p: torch.optim.Adam(p, lr=0.1, weight_decay=1e-2),
        "adamw": lambda p: torch.optim.AdamW(p, lr=0.1, weight_decay=1e-2),
        "rmsprop": lambda p: RMSProp(p, lr=0.1, momentum=0.5,
                                     weight_decay=1e-2)}[kind]
    rng = np.random.RandomState(0)
    p0 = torch.from_numpy(rng.randn(7).astype(np.float32)).to(dev)
    grads = torch.from_numpy(rng.randn(20, 7).astype(np.float32)).to(dev)
    ref = torch.nn.Parameter(p0.clone())
    ref_opt = make([ref])
    ours = torch.nn.Parameter(p0.clone())
    opt = capturable(make([ours]))
    grad = torch.zeros_like(p0)
    ours.grad = grad
    lrs = [0.1 * (1 - i / 20) ** 0.9 for i in range(20)]
    set_lr(opt, lrs[0])
    grad.copy_(grads[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        opt.step()  # the warm-up: lazy slots
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step()
    for i in range(20):
        for group in ref_opt.param_groups:
            group["lr"] = lrs[i]
        ref.grad = grads[i].clone()
        ref_opt.step()
        if i:
            set_lr(opt, lrs[i])
            grad.copy_(grads[i])
            graph.replay()
        torch.testing.assert_close(ours.detach(), ref.detach(), atol=1e-5,
                                   rtol=1e-5, msg=str(i))


def test_loader_reads_device_batches_into_pinned_memory(dev, tmp_path):
    """With ``pin_memory`` (the train loop's setting for a card) a
    ``device``-mode batch comes from the native reader in pinned memory,
    equal to the unpinned loader's; the prefetcher's pin is then a no-op
    (the same buffer) and its copy on the card equals the batch."""
    from medicalseg_torch.core.loader import TrainLoader
    from medicalseg_torch.core.prefetch import DevicePrefetcher
    from medicalseg_torch.datasets import MedicalDataset
    from medicalseg_torch.transforms import RandomFlip3D
    phase0 = tmp_path / "phase0"
    rng = np.random.RandomState(9)
    lines = []
    for i in range(3):
        for sub, vol in (("images", rng.rand(6, 10, 12).astype(np.float32)),
                         ("labels", rng.randint(0, 20, (6, 10, 12))
                          .astype(np.uint8))):
            (phase0 / sub).mkdir(parents=True, exist_ok=True)
            np.save(phase0 / sub / "v{}.npy".format(i), vol)
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    (phase0 / "train_list.txt").write_text("".join(lines))
    ds = MedicalDataset(str(phase0), str(phase0), [RandomFlip3D()], 20,
                        repeat_train=2)
    kw = dict(batch_size=2, num_workers=2, seed=1, mode="device",
              wire_dtype="bfloat16")
    pinned = TrainLoader(ds, pin_memory=True, **kw)
    plain = TrainLoader(ds, **kw)
    try:
        for _ in range(4):
            got, want = next(pinned), next(plain)
            for g, w in zip(got, want):
                assert g.is_pinned() and not w.is_pinned()
                assert g.pin_memory().data_ptr() == g.data_ptr()
                assert torch.equal(g, w)
    finally:
        pinned.stop()
        plain.stop()
    loader = TrainLoader(ds, pin_memory=True, **kw)
    check = TrainLoader(ds, **kw)
    prefetcher = DevicePrefetcher(loader, dev)
    try:
        for _ in range(4):
            images, labels = next(prefetcher)
            want_images, want_labels = next(check)
            assert images.device.type == "cuda"
            assert torch.equal(images.cpu(), want_images)
            assert torch.equal(labels.cpu(), want_labels)
    finally:
        prefetcher.close()
        loader.stop()
        check.stop()


# --------------------------------------------------------------------------
# the graphed sharded step over NCCL (a card a rank)
# --------------------------------------------------------------------------
def _nccl_steps(mesh, device, edge):
    """Four cached steps eager and four through the graph (the warm-up and
    three replays) over ``mesh`` at ``edge``^3: whether each step's loss,
    parameters, statistics and momentum were the eager step's bit for bit,
    the replays and the launches of a replay."""
    from medicalseg_torch.core.state import make_cached_train_step
    from medicalseg_torch.transforms.device import step_seed
    rng = np.random.RandomState(7)
    shape = (4, edge, edge, edge)
    cache = (torch.from_numpy(rng.rand(*shape, 1).astype(
        np.float32)).to(device), torch.from_numpy(rng.randint(
            0, 3, shape).astype(np.uint8)).to(device))
    stream = rng.randint(0, 4, (4, 2)).astype(np.int32)

    def written(state):
        out = [v.clone() for v in state.model.state_dict().values()]
        return out + [state.optimizer.state[p]["momentum_buffer"].clone()
                      for p in state.model.parameters()]

    eager, after, losses = _graph_trainer(), [], []
    step = make_train_step(_graph_losses(), mesh=mesh)
    for idx in stream:
        eager.generator.manual_seed(step_seed(3, eager.step))
        i = torch.from_numpy(idx).long().to(device)
        _, m = step(eager, cache[0][i], cache[1][i])
        losses.append(m["loss"].item())
        after.append(written(eager))
    graphed = _graph_trainer()
    cached = make_cached_train_step(_graph_losses(), mesh=mesh)
    same = []
    for k, idx in enumerate(stream):
        _, m = cached(graphed, *cache, idx, seed=3)
        same.append(m["loss"].item() == losses[k] and all(
            torch.equal(a, b) for a, b in zip(written(graphed), after[k])))
    return {"same": same, "replays": cached.graphed.replays,
            "launches": cached.graphed.launches}


def _nccl_rank(rank, world, tmp, edge):
    """One rank of :func:`test_graphed_sharded_step_is_the_eager_one`
    (:func:`_nccl_steps` over a space ``world`` mesh); writes its result.
    The graph holds the process group's communicators: it is freed, and the
    ranks meet, before the group is destroyed (destroying it under a live
    graph hung on an H100 pair). A rank still running after 200 s prints
    its threads' stacks."""
    import faulthandler
    import gc
    import os

    import torch.distributed as dist

    from medicalseg_torch.parallel import build_mesh, init_process_group
    faulthandler.dump_traceback_later(200, exit=False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    device, backend = init_process_group(rank, world, "cuda", rank, world,
                                         store=store)
    try:
        out = _nccl_steps(build_mesh(space=world), device, edge)
        out["backend"] = backend
        torch.save(out, os.path.join(tmp, "rank{}.pt".format(rank)))
        gc.collect()
        torch.cuda.synchronize(device)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("edge", [64, 32])
def test_graphed_sharded_step_is_the_eager_one(dev, tmp_path, edge):
    """Over NCCL with a card a rank (space 2; at 32^3 the H blocks run 16
    -> 1 rows, so the shortest take their halo through a gather, at 64^3
    every halo is an exchange), the cached step's replays of one CUDA
    graph a rank are the eager sharded step bit for bit on every rank,
    and every rank's replay launches the same kernels. The ranks are
    killed after 240 s."""
    import time

    import torch.multiprocessing as mp
    world = 2
    if torch.cuda.device_count() < world:
        pytest.skip("needs a card a rank: {} cards".format(
            torch.cuda.device_count()))
    ctx = mp.spawn(_nccl_rank, args=(world, str(tmp_path), edge),
                   nprocs=world, join=False)
    deadline = time.time() + 240
    try:
        while not ctx.join(timeout=1):
            assert time.time() < deadline, "the ranks ran past 240 s"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    got = [torch.load(tmp_path / "rank{}.pt".format(r)) for r in range(world)]
    for r in got:
        assert r["backend"] == "nccl" and r["replays"] == 3
        assert r["same"] == [True] * 4
        assert r["launches"] == got[0]["launches"]
        assert sum(r["launches"].values()) > 0


# --------------------------------------------------------------------------
# asynchronous checkpoint writes in a graphed run
# --------------------------------------------------------------------------
def test_async_save_in_a_graphed_run_is_the_sync_save(dev, tmp_path):
    """``core.train`` with the dataset on the card and two steps a
    dispatch (replays of one CUDA graph, which change the parameters in
    place) on the flagship YAML at (8, 32, 32): the checkpoint written
    asynchronously at iteration 2, with the next dispatch right behind its
    snapshot, and the one at 4 hold the bytes of the synchronous run's."""
    import os

    from medicalseg_torch.core.train import train
    from medicalseg_torch.cvlibs import Config
    phase0 = tmp_path / "phase0"
    rng = np.random.RandomState(4)
    lines = []
    for i in range(3):
        for sub, vol in (("images", rng.rand(8, 32, 32).astype(np.float32)),
                         ("labels", rng.randint(0, 20, (8, 32, 32))
                          .astype(np.uint8))):
            (phase0 / sub).mkdir(parents=True, exist_ok=True)
            np.save(phase0 / sub / "v{}.npy".format(i), vol)
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    (phase0 / "train_list.txt").write_text("".join(lines))
    (phase0 / "val_list.txt").write_text("".join(lines))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "synthetic",
                           "vnetdeepsup_synspine_15k.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data_root"] = str(tmp_path)
    for key in ("train_dataset", "val_dataset"):
        cfg[key]["dataset_root"] = "phase0"
        cfg[key]["result_dir"] = "phase1"
    cfg["batch_size"] = 1
    path = tmp_path / "spine.yml"
    path.write_text(yaml.safe_dump(cfg))
    files = []
    for async_checkpoint in (True, False):
        config = Config(str(path), iters=4)
        out = tmp_path / "out_{}".format(async_checkpoint)
        state = train(config.model, config.train_dataset,
                      optimizer=config.build_optimizer,
                      lr_scheduler=config.lr_scheduler, save_dir=str(out),
                      iters=4, batch_size=1, save_interval=2, log_iters=2,
                      losses=config.loss, seed=0,
                      data_loader_mode="device_cache", steps_per_dispatch=2,
                      async_checkpoint=async_checkpoint, device="cuda")
        assert state.step == 4
        files.append({"{}/{}".format(it, name): (out / it / name).read_bytes()
                      for it in ("iter_2", "iter_4")
                      for name in ("model.msgpack", "opt.msgpack")})
    assert files[0].keys() == files[1].keys()
    for name in files[0]:
        assert files[0][name] == files[1][name], name
    assert files[0]["iter_2/model.msgpack"] != files[0]["iter_4/model.msgpack"]
