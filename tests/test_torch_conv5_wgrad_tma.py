"""What the CPU can hold of the tensor-copy weight-gradient kernel
(``wgrad_tma_kernel``, medicalseg_torch/csrc/conv5_wgrad_tma.cu): its launch
geometry against the kernel's limits, the gate that sends a conv to it, and
its operand words and order of summation emulated in plain PyTorch. The
kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it to the plain version there).

Tolerance: the emulation against the plain version is float32 on
bf16-representable operands, the same products summed in another order:
atol = rtol = 1e-5 (scaled by the result's magnitude).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from medicalseg_torch.models import VNet
from medicalseg_torch.ops import conv5 as c5

SMEM_MAX = 227 * 1024
SMS = 132
REGISTERS = 65536  # 32-bit registers of an H100 SM
# (Ci = Co, edge) of the square and wide convs of one V-Net pass at 128^3
VNET = [(32, 64), (64, 32), (128, 16), (256, 8), (256, 16), (128, 32),
        (64, 64), (32, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# (a) launch geometry
# ----------------------------------------------------------------------
def _check_geometry(n, d, h, w, ci, co):
    q = c5.conv5_wgrad_tma_geometry(n, d, h, w, ci, co)
    th, tw = q["th"], q["tw"]
    assert tw == (8 if w <= 8 else 16 if w <= 16 else 32)
    # th even (a K step at tw = 8 spans two rows), at most 8 rows
    assert 2 <= th <= 8 and th % 2 == 0
    # the x box holds the tile, its halo and the 8 columns left of it (a
    # box starts on 16 bytes); the g box holds the tile
    assert q["xrows"] >= th + 4 and q["xw"] >= tw + 8 + 2
    assert q["grows"] >= th and q["gw"] >= tw
    assert q["xw"] % 8 == 0 and q["gw"] % 8 == 0
    assert max(q["xw"], q["xrows"], q["gw"], q["grows"]) <= 256
    # an odd number of 16-byte units per channel: conflict-free fragments
    assert (q["xrows"] * q["xw"] // 8) % 2 == 1
    assert (q["grows"] * q["gw"] // 8) % 2 == 1
    # 32 channels of bf16 per box, each box a multiple of 128 bytes
    assert q["x_bytes"] == 32 * q["xrows"] * q["xw"] * 2
    assert q["g_bytes"] == 32 * q["grows"] * q["gw"] * 2
    assert q["x_bytes"] % 128 == 0 and q["g_bytes"] % 128 == 0
    assert q["stage"] == q["x_bytes"] + q["g_bytes"]
    # the ring: 3 to 8 stages, as many as fit the block's shared memory
    assert 3 <= q["stages"] <= 8
    assert q["smem"] == 128 + q["stages"] * q["stage"] <= SMEM_MAX
    assert q["stages"] == 8 or q["smem"] + q["stage"] > SMEM_MAX
    # 10 consumer warps and the loader; 25 taps x 32 x 32 f32 accumulators
    # (100 KB) are 80 a consumer thread, well inside the register file
    assert q["threads"] == 32 * 11
    acc_regs = 25 * 32 * 32
    assert acc_regs // (32 * 10) == 80 and acc_regs <= REGISTERS // 2
    # the grid: CUDA's limits, every (kd, ci tile, co tile) a block column
    assert q["chan_blocks"] == 5 * -(-ci // 32) * -(-co // 32)
    assert q["grid"] == (q["chan_blocks"], q["splits"])
    assert q["chan_blocks"] < 2 ** 31 and 1 <= q["splits"] <= 65535
    tiles = n * d * -(-h // th) * -(-w // tw)
    per = -(-tiles // q["splits"])
    assert q["splits"] <= tiles and per * (q["splits"] - 1) < tiles
    return q


@pytest.mark.parametrize("ci,edge", VNET)
def test_geometry_vnet_convs(ci, edge):
    q = _check_geometry(2, edge, edge, edge, ci, ci)
    # a full 8-row tile everywhere; at the 128^3 level enough splits for a
    # block on nearly every SM
    assert q["th"] == 8
    if edge == 128:
        assert q["chan_blocks"] * q["splits"] >= 0.9 * SMS


@pytest.mark.parametrize("ci,co", [(32, 32), (64, 64), (128, 128),
                                   (256, 256), (16, 32), (32, 64)])
def test_geometry_spine_shapes(ci, co):
    """The spine parity geometry (1, 8, 32, 32) and the levels below it."""
    for level in range(3):
        _check_geometry(1, max(1, 8 >> level), 32 >> level, 32 >> level,
                        ci, co)


@settings(max_examples=120, deadline=None)
@given(n=st.integers(1, 3), d=st.integers(1, 40), h=st.integers(1, 70),
       w=st.integers(1, 70), ci=st.integers(2, 256), co=st.integers(17, 256))
def test_geometry_odd_shapes(n, d, h, w, ci, co):
    _check_geometry(n, d, h, w, ci, co)


# ----------------------------------------------------------------------
# (b) the gate
# ----------------------------------------------------------------------
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("ci,edge", VNET)
def test_gate_sends_every_main_path_view_to_the_tma_kernel(ci, edge):
    """The main path hands the weight gradient contiguous views (the layer's
    input and the pinned cotangent) at the V-Net shapes: all take it."""
    x = _meta((2, edge, ci, edge, edge))
    g = _meta((2, edge, ci, edge, edge))
    assert c5.conv5_wgrad_form(x, g, "head") == "tma"


@pytest.mark.parametrize("what,x_shape,co,dtype,kind,form", [
    ("ragged-w100", (1, 3, 24, 7, 100), 33, torch.bfloat16, "head",
     "ragged"),
    ("ragged-w10", (1, 5, 3, 9, 10), 40, torch.bfloat16, "head", "ragged"),
    ("f32", (2, 8, 64, 8, 16), 64, torch.float32, "head", "tf32"),
    ("narrow-head", (2, 8, 32, 8, 16), 3, torch.bfloat16, "head",
     "head_tma"),
    ("co16", (2, 8, 32, 8, 16), 16, torch.bfloat16, "head", "head_tma"),
    ("narrow-head-f32", (2, 8, 32, 8, 16), 3, torch.float32, "head", "tf32"),
    ("narrow-head-w12", (2, 8, 32, 8, 12), 3, torch.bfloat16, "head",
     "head_ragged"),
    ("stem", (2, 8, 1, 8, 16), 16, torch.bfloat16, "stem", "stem_tc"),
    ("stem-f32", (2, 8, 1, 8, 16), 16, torch.float32, "stem",
     "stem_tf32"),
    ("co17", (1, 4, 5, 6, 8), 17, torch.bfloat16, "head", "tma")])
def test_gate_forms(what, x_shape, co, dtype, kind, form):
    n, d, _, h, w = x_shape
    x, g = _meta(x_shape, dtype), _meta((n, d, co, h, w), dtype)
    assert c5.conv5_wgrad_form(x, g, kind) == form


def test_gate_follows_the_views_a_tensor_copy_can_describe():
    x = torch.zeros((2, 3, 32, 4, 16), dtype=torch.bfloat16)
    g = torch.zeros((2, 3, 48, 4, 16), dtype=torch.bfloat16)
    assert c5.conv5_wgrad_form(x, g, "head") == "tma"
    # a [N, C, D, H, W] tensor seen as [N, D, C, H, W]: its own strides
    view = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    assert c5.conv5_wgrad_form(view, g, "head") == "tma"
    # a base 2 bytes into an allocation: the kernel's software producer
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    assert c5.conv5_wgrad_form(flat[1:].view(x.shape), g, "head") == "ragged"
    # rows that do not start on 16 bytes (W = 12, contiguous)
    x12, g12 = x[..., :12].contiguous(), g[..., :12].contiguous()
    assert c5.conv5_wgrad_form(x12, g12, "head") == "ragged"
    # the same extent cut from W = 16: rows 32 bytes apart, a tensor copy
    # reads it with zeros past column 12
    assert c5.conv5_wgrad_form(x[..., :12], g[..., :12], "head") == "tma"
    # a depth slice of a wider tensor keeps aligned strides
    assert c5.conv5_wgrad_form(x[:, 1:], g[:, 1:], "head") == "tma"


def test_main_path_hands_the_weight_gradient_contiguous_operands(
        monkeypatch):
    """A bf16 V-Net backward on the CPU, the weight-gradient wrapper
    recorded: every square and wide conv's operands are contiguous, those
    at a W that is a multiple of 8 (16 and 8 at this input; every level at
    128^3) go to the tensor copy and the rest to the same kernel's software
    producer."""
    seen = []
    plain = c5.conv5_wgrad_kl

    def record(xk, gk, kind="head"):
        seen.append((xk.is_contiguous() and gk.is_contiguous(), kind,
                     gk.shape[2], xk.shape[4], c5.conv5_wgrad_form(
                         xk, gk, kind)))
        return plain(xk, gk, kind)

    monkeypatch.setattr(c5, "conv5_wgrad_kl", record)
    model = VNet(num_classes=3, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.RandomState(4).rand(
        1, 16, 16, 16, 1).astype(np.float32))
    model(x)[0].float().sum().backward()
    assert len(seen) == 16
    wide = [s for s in seen if s[1] == "head" and s[2] > 16]
    assert len(wide) == 14 and all(s[0] for s in seen)
    assert all(s[4] == ("tma" if s[3] % 8 == 0 else "ragged") for s in wide)
    assert sum(s[4] == "tma" for s in wide) == 3


# ----------------------------------------------------------------------
# (c) the kernel's operand words and order of summation
# ----------------------------------------------------------------------
def _words(box):
    """bf16 box [..., cols] -> its 32-bit words [..., cols / 2]: element
    2k in the low half, 2k + 1 in the high half, as shared memory holds
    them."""
    u = box.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return u[..., 0::2] | (u[..., 1::2] << 16)


def _byte_perm_5432(lo, hi):
    """__byte_perm(lo, hi, 0x5432): the high half of lo, then the low half
    of hi."""
    return (lo >> 16) | ((hi & 0xFFFF) << 16)


def _halves(word):
    """32-bit words -> their (low, high) bf16 values as f32, on a new last
    axis."""
    bits = torch.stack([word & 0xFFFF, word >> 16], -1).to(torch.int16)
    return bits.view(torch.bfloat16).float()


def _emulate_tma(xk, gk, q):
    """The kernel's arithmetic: boxes cut as the tensor copy brings them
    (zeros outside the volume), per K step the fragment words of the 5 kw
    taps (aligned words at even shifts, byte-permuted neighbours at odd
    ones) and of g, one [25 taps, ci, 16] x [16, co] product added to the
    split's f32 sum, tiles in the split's order, the partials summed in
    split order. Returns f32 [5, 5, 5, Ci, Co]."""
    n, d, ci, h, w = xk.shape
    co = gk.shape[2]
    th, tw = q["th"], q["tw"]
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    cip, cop = -(-ci // 32) * 32, -(-co // 32) * 32
    # the volume as the boxes see it: 8 columns and 2 rows of zeros before
    # it, enough after it for the last tile's box
    xp = F.pad(xk, (8, tiles_w * tw + q["xw"], 2, tiles_h * th + q["xrows"],
                    0, cip - ci))
    gp = F.pad(gk, (0, tiles_w * tw + q["gw"], 0, tiles_h * th + q["grows"],
                    0, cop - co))
    tiles = n * d * tiles_h * tiles_w
    per = -(-tiles // q["splits"])
    k = torch.arange(16)
    parts = []
    for s in range(q["splits"]):
        acc = torch.zeros((5, 5, 5, cip, cop))
        for t in range(s * per, min(tiles, (s + 1) * per)):
            w0 = t % tiles_w * tw
            h0 = t // tiles_w % tiles_h * th
            od = t // (tiles_w * tiles_h) % d
            nb = t // (tiles_w * tiles_h * d)
            xw = _words(xp[nb, :, :, h0:h0 + q["xrows"], w0:w0 + q["xw"]])
            gw = _words(gp[nb, od, :, h0:h0 + q["grows"], w0:w0 + q["gw"]])
            steps = ([(row, ws) for row in range(th) for ws in range(0, tw, 16)]
                     if tw >= 16 else [(row, 0) for row in range(0, th, 2)])
            for kd in range(5):
                idd = od + kd - 2
                if not 0 <= idd < d:
                    continue  # only padding: the block skips the tile
                for row, ws in steps:
                    # K index k = 8 * half + 2 * p + j: the word of pair p
                    # of half `half`, element j
                    half, pair, j = k // 8, k % 8 // 2, k % 2
                    if tw >= 16:
                        rows, col = row + 0 * half, ws // 2 + 4 * half + pair
                    else:
                        rows, col = row + half, pair
                    b = _halves(gw[:, rows, col])[:, k, j]  # [cop, 16]
                    a = torch.empty((5, 5, cip, 16))
                    for kh in range(5):
                        base = xw[idd, :, rows + kh, col + 3]  # [cip, 16]
                        nxt = xw[idd, :, rows + kh, col + 4]
                        last = xw[idd, :, rows + kh, col + 5]
                        taps = [base, _byte_perm_5432(base, nxt), nxt,
                                _byte_perm_5432(nxt, last), last]
                        for kw in range(5):
                            a[kh, kw] = _halves(taps[kw])[:, k, j]
                    acc[kd] += a @ b.t()
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out[..., :ci, :co]


def _bf16_values(shape, rng):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("n,d,ci,h,w,co", [
    (1, 3, 8, 6, 8, 24),     # W = 8: a K step is 8 w x 2 rows
    (2, 2, 5, 4, 16, 20),    # tw = 16
    (1, 3, 6, 3, 24, 18),    # tw = 32, a ragged tile
    (1, 2, 40, 2, 16, 36)])  # two ci tiles and two co tiles
def test_emulated_wgrad_equals_plain(n, d, ci, h, w, co):
    rng = np.random.RandomState(ci + co)
    xk = _bf16_values((n, d, ci, h, w), rng)
    gk = _bf16_values((n, d, co, h, w), rng)
    q = c5.conv5_wgrad_tma_geometry(n, d, h, w, ci, co)
    got = _emulate_tma(xk, gk, q)
    ref = c5.conv5_wgrad_kl_plain(xk, gk)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_emulated_splits_and_fixed_order_reduce(splits):
    """The voxel split changes which tiles a block sums, not the result;
    the partials are summed in split order, so the same split gives the
    same bits twice."""
    rng = np.random.RandomState(splits)
    xk = _bf16_values((1, 3, 6, 4, 16), rng)
    gk = _bf16_values((1, 3, 20, 4, 16), rng)
    q = dict(c5.conv5_wgrad_tma_geometry(1, 3, 4, 16, 6, 20), splits=splits)
    got = _emulate_tma(xk, gk, q)
    assert torch.equal(got, _emulate_tma(xk, gk, q))
    ref = c5.conv5_wgrad_kl_plain(xk, gk)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(),
                               rtol=1e-5)


def test_byte_perm_gives_the_odd_shift():
    """At an odd kw shift the pair (w, w + 1) straddles two words: the high
    half of the first and the low half of the second."""
    row = torch.arange(1, 9, dtype=torch.float32)  # bf16-exact
    words = _words(row)
    got = _halves(_byte_perm_5432(words[:-1], words[1:]))
    assert torch.equal(got, torch.stack([row[1:-1:2], row[2::2]], -1))
