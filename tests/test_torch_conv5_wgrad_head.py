"""What the CPU can hold of the narrow head's weight-gradient kernel
(``wgrad_head_tma_kernel``, medicalseg_torch/csrc/conv5_wgrad_tma.cu): its
launch geometry against the card's limits, the gate that sends a conv to
it, and its operand words (x unshifted, g shifted by ``__byte_perm``), K
order, voxel splits and fixed-order reduce emulated in plain PyTorch,
against the plain version and against the JAX package's Pallas kernel in
interpret mode. The kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it to the plain version
there).

Tolerances: the emulation against the plain version is float32 on
bf16-representable operands, the same products summed in another order:
atol = rtol = 1e-5, atol scaled by the result's magnitude. Against the
Pallas kernel (f32, interpret mode) 5e-3, the bound the JAX package's own
tests set for that kernel (tests/test_torch_conv5_bwd.py uses the same).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from medicalseg_tpu.ops import pallas_conv5 as pc
from medicalseg_torch.models import VNet
from medicalseg_torch.ops import conv5 as c5

SMEM_MAX = 227 * 1024
SMS = 132
REGISTERS = 65536  # 32-bit registers of an H100 SM
THREAD_REGISTERS = 255


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
def _bank_span(q):
    """The banks one B load of a warp touches: per channel the words at
    offsets 3 .. 8 of the thread's column (p = 0..3, the word at an even
    kw or one left of it), the three channels a pitch apart. True when no
    bank is hit by two different words."""
    pitch = q["grows"] * q["gw"] // 2
    banks = [(c * pitch + off) % 32 for c in range(3) for off in range(3, 9)]
    return len(set(banks)) == len(banks)


def _check_geometry(n, d, h, w, ci, co):
    q = c5.conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co)
    th, tw = q["th"], q["tw"]
    assert tw == (16 if w <= 16 else 32)
    assert 1 <= th <= 8
    # x box: the tile itself, 8 extra columns; an odd number of 16-byte
    # units per channel (conflict-free A loads)
    assert q["xrows"] >= th and q["xw"] == tw + 8
    assert (q["xrows"] * q["xw"] // 8) % 2 == 1
    # g box: the tile, 2 halo rows each side, columns from 8 left of the
    # tile to 2 right of it; pitch chosen so one B load has no conflicts
    assert q["grows"] >= th + 4 and q["gw"] >= tw + 10 and q["gw"] % 8 == 0
    assert max(q["xw"], q["xrows"], q["gw"], q["grows"]) <= 256
    assert _bank_span(q)
    assert q["x_bytes"] == 32 * q["xrows"] * q["xw"] * 2
    assert q["g_bytes"] == 5 * 3 * q["grows"] * q["gw"] * 2
    # the tensor copies land on 128 bytes: the x box at the stage, the g
    # box after it, every stage a multiple of 128 bytes
    assert q["x_bytes"] % 128 == 0 and q["stage"] % 128 == 0
    assert q["x_bytes"] + q["g_bytes"] <= q["stage"] < (
        q["x_bytes"] + q["g_bytes"] + 128)
    assert 2 <= q["stages"] <= 8
    assert q["smem"] == 128 + q["stages"] * q["stage"] <= SMEM_MAX
    assert q["stages"] == 8 or q["smem"] + q["stage"] > SMEM_MAX
    # 10 consumer warps and the loader; 25 (kd, kh) x 32 ci x 16 (co, kw)
    # f32 accumulators, once per tile-row parity, are 80 a consumer thread
    assert q["threads"] == 32 * 11
    acc = 2 * 25 * 32 * 16
    assert acc // (32 * 10) == 80
    assert q["threads"] * 2 * 80 <= REGISTERS and 2 * 80 < THREAD_REGISTERS
    # the grid: every (ci tile, 3-channel co group) a block column
    assert q["chan_blocks"] == -(-ci // 32) * -(-co // 3)
    assert q["grid"] == (q["chan_blocks"], q["splits"])
    assert q["chan_blocks"] < 2 ** 31 and 1 <= q["splits"] <= 65535
    tiles = n * d * -(-h // th) * -(-w // tw)
    per = -(-tiles // q["splits"])
    assert q["splits"] <= tiles and per * (q["splits"] - 1) < tiles
    return q


def test_geometry_vnet_head():
    """out_tr, 32 -> 3 at 128^3, batch 2: full 8 x 32 tiles, a ring of 5,
    one block per SM."""
    q = _check_geometry(2, 128, 128, 128, 32, 3)
    assert (q["th"], q["tw"], q["stages"]) == (8, 32, 5)
    assert q["chan_blocks"] * q["splits"] == SMS


@pytest.mark.parametrize("ci,co", [(32, 3), (16, 3), (32, 16), (64, 8)])
def test_geometry_spine_shapes(ci, co):
    """The spine parity geometry (1, 8, 32, 32) and the levels below it."""
    for level in range(3):
        _check_geometry(1, max(1, 8 >> level), 32 >> level, 32 >> level,
                        ci, co)


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 3), d=st.integers(1, 40), h=st.integers(1, 70),
       w=st.integers(1, 300), ci=st.integers(2, 256), co=st.integers(1, 16))
def test_geometry_odd_shapes(n, d, h, w, ci, co):
    _check_geometry(n, d, h, w, ci, co)


# ----------------------------------------------------------------------
# (b) the gate
# ----------------------------------------------------------------------
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("what,x_shape,co,dtype,form", [
    ("vnet-head", (2, 128, 32, 128, 128), 3, torch.bfloat16, "head_tma"),
    ("co16", (1, 4, 8, 6, 16), 16, torch.bfloat16, "head_tma"),
    ("co1", (1, 4, 5, 6, 8), 1, torch.bfloat16, "head_tma"),
    ("f32", (2, 8, 32, 8, 16), 3, torch.float32, "tf32"),
    ("w-not-16-byte-rows", (1, 3, 24, 7, 100), 3, torch.bfloat16,
     "head_ragged"),
    ("co17", (1, 4, 5, 6, 8), 17, torch.bfloat16, "tma")])
def test_gate_forms(what, x_shape, co, dtype, form):
    n, d, _, h, w = x_shape
    x, g = _meta(x_shape, dtype), _meta((n, d, co, h, w), dtype)
    assert c5.conv5_wgrad_form(x, g, "head") == form


def test_gate_follows_the_views_a_tensor_copy_can_describe():
    x = torch.zeros((2, 3, 32, 4, 16), dtype=torch.bfloat16)
    g = torch.zeros((2, 3, 3, 4, 16), dtype=torch.bfloat16)
    assert c5.conv5_wgrad_form(x, g, "head") == "head_tma"
    # g as a channel slice of a wider tensor: its own strides, no copy
    wide = torch.zeros((2, 3, 8, 4, 16), dtype=torch.bfloat16)
    assert c5.conv5_wgrad_form(x, wide[:, :, 2:5], "head") == "head_tma"
    # a base 2 bytes into an allocation: the kernel's software producer
    flat = torch.zeros(g.numel() + 1, dtype=g.dtype)
    assert c5.conv5_wgrad_form(x, flat[1:].view(g.shape),
                               "head") == "head_ragged"
    # rows that do not start on 16 bytes (W = 12, contiguous)
    x12, g12 = x[..., :12].contiguous(), g[..., :12].contiguous()
    assert c5.conv5_wgrad_form(x12, g12, "head") == "head_ragged"
    # a bf16 stem takes stem_wgrad_tc_kernel, whatever its views
    assert c5.conv5_wgrad_form(x, g, "stem") == "stem_tc"


def test_main_path_hands_the_narrow_head_to_the_tma_kernel(monkeypatch):
    """A bf16 V-Net backward on the CPU, the weight-gradient wrapper
    recorded: the one narrow head (out_tr, 32 -> 3) gets contiguous
    operands that the new kernel takes."""
    seen = []
    plain = c5.conv5_wgrad_kl

    def record(xk, gk, kind="head"):
        seen.append((kind, xk.shape[2], gk.shape[2],
                     c5.conv5_wgrad_form(xk, gk, kind)))
        return plain(xk, gk, kind)

    monkeypatch.setattr(c5, "conv5_wgrad_kl", record)
    model = VNet(num_classes=3, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.RandomState(6).rand(
        1, 16, 16, 16, 1).astype(np.float32))
    model(x)[0].float().sum().backward()
    narrow = [s for s in seen if s[0] == "head" and s[2] <= 16]
    assert narrow == [("head", 32, 3, "head_tma")]


# ----------------------------------------------------------------------
# (c) the kernel's operand words and order of summation
# ----------------------------------------------------------------------
def _words(box):
    """bf16 box [..., cols] -> its 32-bit words [..., cols / 2]: element
    2k in the low half, 2k + 1 in the high half."""
    u = box.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return u[..., 0::2] | (u[..., 1::2] << 16)


def _byte_perm(lo, hi, sel):
    """__byte_perm(lo, hi, sel) for the two selectors the kernel uses:
    0x3210 keeps lo, 0x5432 takes the high half of lo, then the low half
    of hi."""
    if sel == 0x3210:
        return lo
    assert sel == 0x5432
    return (lo >> 16) | ((hi & 0xFFFF) << 16)


def _halves(word):
    """32-bit words -> their (low, high) bf16 values as f32, on a new last
    axis."""
    bits = torch.stack([word & 0xFFFF, word >> 16], -1).to(torch.int16)
    return bits.view(torch.bfloat16).float()


# (co, kw) of B column n of the two n8 tiles: thread row r holds column r
# of tile 0 and of tile 1; rows 0-5 a channel's (kw, kw + 1) for even kw,
# row 6 kw = 4 of channels 0 and 1, row 7 kw = 4 of channel 2 and the
# padding column (None)
COLUMNS = ([(r >> 1, 2 * (r & 1)) for r in range(6)] + [(0, 4), (2, 4)] +
           [(r >> 1, 2 * (r & 1) + 1) for r in range(6)] + [(1, 4), None])


def _emulate_head(xk, gk, q):
    """The kernel's arithmetic: per (n, d, tile) the x box at the tile and
    the g box of 5 depths x 3 channels from 2 depths, 2 rows and 8 columns
    before it, cut as the tensor copy brings them (zeros outside the
    volume); per K step (16 w of one row) the A words of x as they lie and,
    for each (kd, kh), the thread's two g words (at an even kw and one
    left of it, or kw = 4 of two channels) and the B words of its two
    columns from them (the aligned word, or __byte_perm(lo, hi, 0x5432) for
    kw + 1; the padding column masked to zero); one [ci, 16] x [16, 16]
    product per (kd, kh) added to the f32 sum of the K step's row parity,
    tiles in the split's order, the two parities added, the partials summed
    in split order. Returns f32 [5, 5, 5, Ci, Co]."""
    n, d, ci, h, w = xk.shape
    co = gk.shape[2]
    th, tw = q["th"], q["tw"]
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    cip, groups = -(-ci // 32) * 32, -(-co // 3)
    xp = F.pad(xk, (0, tiles_w * tw + q["xw"], 0, tiles_h * th + q["xrows"],
                    0, cip - ci))
    gp = F.pad(gk, (8, tiles_w * tw + q["gw"], 2, tiles_h * th + q["grows"],
                    0, 3 * groups - co, 2, 5))
    tiles = n * d * tiles_h * tiles_w
    per = -(-tiles // q["splits"])
    # the thread's K index k = 8 * half + 2 * pair + j
    k = torch.arange(16)
    half, pair, j = k // 8, k % 8 // 2, k % 2
    # per column: the (channel, word offset) of the word it is made of and,
    # for kw + 1 columns, of the word left of it (else the same word)
    chan = torch.tensor([c[0] if c else 2 for c in COLUMNS])
    kws = torch.tensor([c[1] if c else 4 for c in COLUMNS])
    odd = kws % 2 == 1
    valid = torch.tensor([c is not None for c in COLUMNS])
    parts = []
    for s in range(q["splits"]):
        acc = torch.zeros((2, groups, 5, 5, cip, 16))  # [row parity, ...]
        for t in range(s * per, min(tiles, (s + 1) * per)):
            w0 = t % tiles_w * tw
            h0 = t // tiles_w % tiles_h * th
            ud = t // (tiles_w * tiles_h) % d
            nb = t // (tiles_w * tiles_h * d)
            xw = _words(xp[nb, ud, :, h0:h0 + q["xrows"], w0:w0 + q["xw"]])
            for o in range(groups):
                gw = _words(gp[nb, ud:ud + 5, 3 * o:3 * o + 3,
                               h0:h0 + q["grows"], w0:w0 + q["gw"]])
                for row in range(th):
                    for ws in range(0, tw, 16):
                        a = _halves(xw[:, row, ws // 2 + 4 * half + pair])
                        a = a[:, k, j]  # [cip, 16]
                        # the even kw's word; a kw + 1 column also reads
                        # the word left of it
                        even = (ws // 2 + 4 * half[:, None] + pair[:, None]
                                + (10 - (kws - odd.long())[None, :]) // 2)
                        for kd in range(5):
                            for kh in range(5):
                                rows = gw[4 - kd, :, row + 4 - kh]
                                v = rows[chan[None, :], even]
                                u = rows[chan[None, :], even - 1]
                                word = torch.where(
                                    odd[None, :], _byte_perm(u, v, 0x5432),
                                    _byte_perm(v, v, 0x3210))
                                b = _halves(word)[k, :, j]  # [16 k, 16 n]
                                b = torch.where(valid[None, :], b, 0.0)
                                acc[row % 2, o, kd, kh] += a @ b
        parts.append(acc)
    total = None
    for part in parts:
        both = part[0] + part[1]  # the even-row warp adds the odd-row sums
        total = both if total is None else total + both
    # column n = (co, kw): dW[kd, kh, kw, ci, 3 * o + co]
    dw = torch.zeros((5, 5, 5, cip, 3 * groups))
    for n, col in enumerate(COLUMNS):
        if col is not None:
            c, kw = col
            dw[:, :, kw, :, c::3] = total[..., n].permute(1, 2, 3, 0)
    return dw[..., :ci, :co]


def _bf16_values(shape, rng):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("n,d,ci,h,w,co", [
    (1, 3, 8, 4, 16, 3),     # tw = 16
    (1, 2, 6, 3, 24, 3),     # tw = 32, a ragged tile and a ragged row count
    (2, 2, 5, 2, 8, 1),      # W narrower than the tile, one channel
    (1, 2, 40, 2, 16, 7)])   # two ci tiles and three co groups
def test_emulated_wgrad_equals_plain(n, d, ci, h, w, co):
    rng = np.random.RandomState(ci + co)
    xk = _bf16_values((n, d, ci, h, w), rng)
    gk = _bf16_values((n, d, co, h, w), rng)
    q = c5.conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co)
    got = _emulate_head(xk, gk, q)
    ref = c5.conv5_wgrad_kl_plain(xk, gk)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_emulated_splits_and_fixed_order_reduce(splits):
    """The voxel split changes which tiles a block sums, not the result;
    the partials are summed in split order, so the same split gives the
    same bits twice."""
    rng = np.random.RandomState(splits)
    xk = _bf16_values((1, 3, 6, 4, 16), rng)
    gk = _bf16_values((1, 3, 3, 4, 16), rng)
    q = dict(c5.conv5_wgrad_head_tma_geometry(1, 3, 4, 16, 6, 3),
             splits=splits)
    got = _emulate_head(xk, gk, q)
    assert torch.equal(got, _emulate_head(xk, gk, q))
    ref = c5.conv5_wgrad_kl_plain(xk, gk)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(),
                               rtol=1e-5)


@pytest.mark.parametrize("kw", range(5))
def test_g_shift_words(kw):
    """The B word of K pair p at tap kw: g at columns (2p + 8 + 2 - kw,
    + 1) of a box that starts 8 columns left of the tile, i.e. g[u - kw +
    2] for u = 2p, 2p + 1: at even kw the word (10 - kw) / 2 + p, at odd
    kw __byte_perm of the word left of the even kw - 1's and that word."""
    row = torch.arange(1, 49, dtype=torch.float32)  # bf16-exact
    words = _words(row)
    for p in range(4):
        even = p + (10 - kw + kw % 2) // 2
        got = _halves(_byte_perm(words[even - 1], words[even], 0x5432)
                      if kw % 2 else words[even])
        u = 2 * p
        assert got.tolist() == [row[8 + u - kw + 2].item(),
                                row[8 + u + 1 - kw + 2].item()]


def test_columns_cover_every_tap_once():
    """The 16 B columns hold each (co, kw) of the 3 x 5 once, and each
    thread row's two columns read the same words: a channel's even kw and
    kw + 1, or kw = 4 (aligned) of two channels."""
    real = [c for c in COLUMNS if c is not None]
    assert sorted(real) == [(c, k) for c in range(3) for k in range(5)]
    for r in range(8):
        first, second = COLUMNS[r], COLUMNS[8 + r]
        if r < 6:
            assert second == (first[0], first[1] + 1) and first[1] % 2 == 0
        else:
            assert first[1] == 4 and (second is None or second[1] == 4)


def test_emulation_matches_pallas_interpret():
    """The emulated kernel against the JAX package's narrow-head weight
    gradient (the Pallas kernel, interpret mode, f32) at a tiny shape."""
    rng = np.random.RandomState(12)
    xk = _bf16_values((1, 4, 8, 8, 128), rng)
    gk = _bf16_values((1, 4, 3, 8, 128), rng)
    ref = np.asarray(pc._conv5_wgrad_kl(jnp.asarray(xk.numpy()),
                                        jnp.asarray(gk.numpy()), "head",
                                        interpret=True))
    q = c5.conv5_wgrad_head_tma_geometry(1, 4, 8, 128, 8, 3)
    got = _emulate_head(xk, gk, q).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=5e-3)
