"""What the CPU can hold of the bf16 stem's weight-gradient kernel
(``stem_wgrad_tc_kernel``, medicalseg_torch/csrc/conv5_stem_wgrad.cu): its
launch geometry against the card's limits, the gate that sends a stem to
it, the banks its B loads hit, and its operand words (g unshifted, x from
the two staged copies of a row), the tap order on N, K order, work items,
the warps' sum in warp order and the blocks' partials summed in block
order, emulated in plain PyTorch, against the plain version and against
the JAX package's Pallas stem weight gradient in interpret mode. The
kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it to the plain version there).

Tolerances: the emulation against the plain version is float32 on
bf16-representable operands, the same products summed in another order:
atol = rtol = 1e-5, atol scaled by the result's magnitude. Against the
Pallas kernel (f32, interpret mode) 5e-3 scaled, the bound
tests/test_torch_conv5_bwd.py sets for the Pallas weight gradients.
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

SMEM_STATIC = 48 * 1024  # static shared memory of a block
SMEM_SM = 227 * 1024
SMS = 132
REGISTERS = 65536  # 32-bit registers of an H100 SM
# the kernel's shared-memory layout (csrc/conv5_stem_wgrad.cu)
ROWW, SLOTW, COPY1, GCP = 44, 540, 20, 132


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
def _check_geometry(n, d, h, w):
    q = c5.conv5_wgrad_stem_tc_geometry(n, d, h, w)
    assert (q["th"], q["tw"], q["threads"], q["blocks_per_sm"]) == (
        8, 32, 256, 2)
    # the depth chunks cover D, none empty; more than one only with 8
    # depths each at least
    assert q["chunks"] * q["dc"] >= d and (q["chunks"] - 1) * q["dc"] < d
    assert q["chunks"] == 1 or q["dc"] >= 8
    tiles = -(-h // 8) * -(-w // 32)
    assert q["tiles"] == tiles
    assert q["items"] == n * q["chunks"] * tiles
    # every block has an item, every item a block, within one wave of two
    # blocks an SM
    assert q["blocks"] * q["per"] >= q["items"]
    assert (q["blocks"] - 1) * q["per"] < q["items"]
    assert q["grid"] == (q["blocks"],) and q["blocks"] <= 2 * SMS
    # ten slots of 12 rows x 44 words padded to 540 words, a ring of three
    # g slices of 16 channels x 132 words: static, twice an SM
    assert q["smem"] == 4 * (10 * SLOTW + 3 * 16 * GCP) <= SMEM_STATIC
    assert SLOTW >= 12 * ROWW and ROWW >= 2 * COPY1
    assert q["blocks_per_sm"] * q["smem"] <= SMEM_SM
    # 64 accumulators and 16 offsets a thread, under the 128 registers of
    # two 256-thread blocks an SM
    assert q["blocks_per_sm"] * q["threads"] * 128 <= REGISTERS
    return q


def test_geometry_cube_stem():
    """in_tr at 128^3, batch 2: 64 tiles x 2 volumes x 2 depth chunks of
    64, one item a block."""
    q = _check_geometry(2, 128, 128, 128)
    assert (q["dc"], q["chunks"], q["items"], q["per"], q["blocks"]) == (
        64, 2, 256, 1, 256)


def test_geometry_flagship_stem():
    """in_tr of the flagship, (3, 12, 1, 512, 512): 1024 tiles a volume,
    the whole depth an item, twelve items a block."""
    q = _check_geometry(3, 12, 512, 512)
    assert (q["dc"], q["chunks"], q["tiles"], q["items"]) == (
        12, 1, 1024, 3072)
    assert (q["per"], q["blocks"]) == (12, 256)


@pytest.mark.parametrize("n,d,h,w", [
    (1, 3, 5, 7),     # W < 16, D < 5, H < 8
    (2, 2, 9, 40),    # W not a multiple of the tile, two row tiles
    (1, 1, 1, 1),
    (1, 4, 3, 100),   # D < 5, four column tiles, the last ragged
    (1, 8, 32, 32)])  # the spine parity geometry
def test_geometry_small_and_ragged(n, d, h, w):
    _check_geometry(n, d, h, w)


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 4), d=st.integers(1, 300), h=st.integers(1, 600),
       w=st.integers(1, 600))
def test_geometry_odd_shapes(n, d, h, w):
    _check_geometry(n, d, h, w)


# ----------------------------------------------------------------------
# (b) the gate
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,kind,co,form", [
    (torch.bfloat16, "stem", 16, "stem_tc"),
    (torch.bfloat16, "stem", 1, "stem_tc"),
    (torch.bfloat16, "stem", 17, "stem"),
    (torch.float32, "stem", 16, "stem_tf32"),
    (torch.bfloat16, "head", 16, "head_tma")])
def test_gate_forms(dtype, kind, co, form):
    ci = 1 if kind == "stem" else 32
    x = torch.empty((2, 4, ci, 8, 16), dtype=dtype, device="meta")
    g = torch.empty((2, 4, co, 8, 16), dtype=dtype, device="meta")
    assert c5.conv5_wgrad_form(x, g, kind) == form


def test_gate_takes_any_w_contiguous_stem_view():
    """The stem kernel reads x and g by their strides at any alignment (g
    by 16-byte words only where a row segment allows them): a view a
    tensor copy could not describe stays on it."""
    x = torch.zeros((1, 3, 1, 4, 13), dtype=torch.bfloat16)
    flat = torch.zeros(3 * 16 * 4 * 13 + 1, dtype=torch.bfloat16)
    g = flat[1:].view(1, 3, 16, 4, 13)
    assert c5.conv5_wgrad_form(x, g, "stem") == "stem_tc"


def test_main_path_hands_the_stem_to_the_tensor_core_kernel(monkeypatch):
    """A bf16 V-Net backward on the CPU, the weight-gradient wrapper
    recorded: the stem's (1 -> 16) weight gradient is the one whose form is
    'stem_tc'."""
    seen = []
    plain = c5.conv5_wgrad_kl

    def record(xk, gk, kind="head"):
        seen.append((kind, c5.conv5_wgrad_form(xk, gk, kind)))
        return plain(xk, gk, kind)

    monkeypatch.setattr(c5, "conv5_wgrad_kl", record)
    model = VNet(num_classes=3, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.RandomState(6).rand(
        1, 16, 16, 16, 1).astype(np.float32))
    model(x)[0].float().sum().backward()
    assert [s for s in seen if s[0] == "stem"] == [("stem", "stem_tc")]
    assert all(f != "stem_tc" for k, f in seen if k != "stem")


# ----------------------------------------------------------------------
# (c) the tap order on N and the banks of the B loads
# ----------------------------------------------------------------------
def _tap(col):
    """(kd, kh, kw) of N column ``col`` as the kernel's tap_row / tap_kw
    give it: kw-major, the (kd, kh) rows ascending for even kw and
    descending for odd kw; the padding columns read tap 0."""
    col = col if col < 125 else 0
    kw, i = divmod(col, 25)
    row = 24 - i if kw % 2 else i
    return row // 5, row % 5, kw


def _offset(col):
    """tap_offset: slot kd, row kh, copy kw % 2, word kw // 2 + 1."""
    kd, kh, kw = _tap(col)
    return kd * SLOTW + kh * ROWW + (kw % 2) * COPY1 + kw // 2 + 1


def test_columns_cover_every_tap_once():
    taps = [_tap(c) for c in range(125)]
    assert sorted(taps) == [(kd, kh, kw) for kd in range(5)
                            for kh in range(5) for kw in range(5)]


def _wavefronts(addresses):
    """Shared-memory wavefronts of one warp load: the most distinct
    32-bit words that fall on one of the 32 banks."""
    banks = {}
    for a in addresses:
        banks.setdefault(a % 32, set()).add(a)
    return max(len(v) for v in banks.values())


def test_b_loads_spread_over_the_banks():
    """Per n8 tile a warp loads lane (r, p)'s word offset(8 j + r) + p
    (and 4 words on): 20 wavefronts over the 16 tiles, 2 at worst (16
    would be conflict-free). The A loads (g: channel r, word p, 132-word
    channel pitch) are conflict-free."""
    fronts = [_wavefronts([_offset(8 * j + r) + p for r in range(8)
                           for p in range(4)]) for j in range(16)]
    assert sum(fronts) == 20 and max(fronts) == 2
    for base in (0, 4, 8, 12):
        assert _wavefronts([r * GCP + base + p for r in range(8)
                            for p in range(4)]) == 1


# ----------------------------------------------------------------------
# (d) the kernel's operand words and order of summation
# ----------------------------------------------------------------------
def _words(box):
    """bf16 box [..., cols] -> its 32-bit words [..., cols / 2]: element
    2k in the low half, 2k + 1 in the high half."""
    u = box.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return u[..., 0::2] | (u[..., 1::2] << 16)


def _halves(word):
    """32-bit words -> their (low, high) bf16 values as f32, on a new last
    axis."""
    bits = torch.stack([word & 0xFFFF, word >> 16], -1).to(torch.int16)
    return bits.view(torch.bfloat16).float()


def _emulate_stem_wgrad(xk, gk, q):
    """The kernel's arithmetic: per block its ``per`` work items in order,
    per item and output depth the five input slices (rows h0 - 2 .. h0 + 9;
    copy 0 the words of x[w0 - 4 ..], copy 1 those of x[w0 - 3 ..]; zeros
    outside the volume) and the g slice (16 channels, zeros past Co); per
    warp (tile row) and K step (16 w) the A words of g and the B word of
    each column (kd, kh, kw) at K pair pi: word kw // 2 + 1 + pi + 8 s of
    copy kw % 2 of slot kd, row warp + kh; one [16, 16] x [16, 128] product
    added to the warp's f32 sums. The eight warps' sums added in warp
    order, the blocks' partials in block order. Returns f32 [5, 5, 5, 1,
    Co]."""
    n, d, _, h, w = xk.shape
    co = gk.shape[2]
    tiles_w = -(-w // 32)
    # padded so that every staged word lies inside: depth 2 + 2, rows 2 +
    # 8 + 2, columns 4 + 36
    xp = F.pad(xk[:, :, 0], (4, tiles_w * 32 + 8, 2, 16, 2, q["dc"] + 8))
    gp = F.pad(gk, (0, tiles_w * 32, 0, 16, 0, 16 - co))
    kd_c, kh_c, kw_c = (torch.tensor(v) for v in zip(*(_tap(c)
                                                      for c in range(128))))
    pi = torch.arange(8)
    warp = torch.arange(8)
    partials = []
    for blk in range(q["blocks"]):
        acc = torch.zeros((8, 16, 128))
        for it in range(blk * q["per"], min(q["items"], (blk + 1) * q["per"])):
            tile, rest = it % q["tiles"], it // q["tiles"]
            chunk, nb = rest % q["chunks"], rest // q["chunks"]
            h0, w0 = tile // tiles_w * 8, tile % tiles_w * 32
            for od in range(chunk * q["dc"], min(d, (chunk + 1) * q["dc"])):
                # slice od - 2 + kd sits at padded depth od + kd
                box = xp[nb, od:od + 5, h0:h0 + 12, w0:w0 + 41]
                copies = torch.stack([_words(box[..., :40]),
                                      _words(box[..., 1:41])], 2)
                gw = _words(gp[nb, od, :, h0:h0 + 8, w0:w0 + 32])
                for s in range(2):
                    # A [warp, co, k]: g[co][row = warp][16 s + k]
                    a = _halves(gw[:, :, 8 * s:8 * s + 8])  # [16, 8, 8, 2]
                    a = a.permute(1, 0, 2, 3).reshape(8, 16, 16)
                    # B [warp, k, col] from the staged words
                    word = copies[kd_c[None, None, :],
                                  warp[:, None, None] + kh_c[None, None, :],
                                  kw_c[None, None, :] % 2,
                                  (kw_c[None, None, :] // 2 + 1 +
                                   pi[None, :, None] + 8 * s)]
                    b = _halves(word).permute(0, 1, 3, 2).reshape(8, 16, 128)
                    acc += a @ b
        total = torch.zeros((16, 128))
        for wp in range(8):
            total = total + acc[wp]
        partials.append(total)
    dw_cols = torch.zeros((16, 128))
    for part in partials:
        dw_cols = dw_cols + part
    dw = torch.zeros((5, 5, 5, 1, co))
    for c in range(125):
        kd, kh, kw = _tap(c)
        dw[kd, kh, kw, 0] = dw_cols[:co, c]
    return dw


def _bf16_values(shape, rng):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("n,d,h,w,co", [
    (1, 3, 5, 7, 16),     # W < 16, D < 5, H < 8
    (2, 2, 9, 40, 16),    # W not a multiple of the tile, two row tiles
    (1, 4, 3, 20, 5),     # Co < 16
    (1, 16, 2, 8, 16)])   # two depth chunks
def test_emulated_wgrad_equals_plain(n, d, h, w, co):
    rng = np.random.RandomState(d + w + co)
    xk = _bf16_values((n, d, 1, h, w), rng)
    gk = _bf16_values((n, d, co, h, w), rng)
    q = c5.conv5_wgrad_stem_tc_geometry(n, d, h, w)
    assert q["chunks"] == (2 if d == 16 else 1)
    got = _emulate_stem_wgrad(xk, gk, q)
    ref = c5.conv5_wgrad_kl_plain(xk, gk)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.parametrize("per", [1, 2, 3])
def test_emulated_items_and_fixed_order_reduce(per):
    """How many items a block walks changes which block sums them, not
    the result; the partials are summed in block order, so the same split
    gives the same bits twice."""
    rng = np.random.RandomState(per)
    xk = _bf16_values((1, 3, 1, 12, 70), rng)
    gk = _bf16_values((1, 3, 16, 12, 70), rng)
    q = c5.conv5_wgrad_stem_tc_geometry(1, 3, 12, 70)
    assert q["items"] == 6
    q = dict(q, per=per, blocks=-(-q["items"] // per))
    got = _emulate_stem_wgrad(xk, gk, q)
    assert torch.equal(got, _emulate_stem_wgrad(xk, gk, q))
    ref = c5.conv5_wgrad_kl_plain(xk, gk)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(),
                               rtol=1e-5)


@pytest.mark.parametrize("kw", range(5))
def test_x_shift_words(kw):
    """The B word of K pair pi at tap kw: x[w0 + 2 pi + kw - 2] and the
    element after it, one aligned word of copy 0 (x from w0 - 4) at even
    kw and of copy 1 (x from w0 - 3) at odd kw: word kw // 2 + 1 + pi."""
    row = torch.arange(1, 42, dtype=torch.float32)  # bf16-exact, x[w0 - 4 + c]
    copies = (_words(row[:40]), _words(row[1:41]))
    for p in range(8):
        got = _halves(copies[kw % 2][kw // 2 + 1 + p])
        c = 4 + 2 * p + kw - 2  # element index of x[w0 + 2 p + kw - 2]
        assert got.tolist() == [row[c].item(), row[c + 1].item()]


def test_emulation_matches_pallas_interpret():
    """The emulated kernel against the JAX package's stem weight gradient
    (the Pallas kernel, interpret mode, f32) at a tiny shape."""
    rng = np.random.RandomState(14)
    xk = _bf16_values((1, 4, 1, 8, 128), rng)
    gk = _bf16_values((1, 4, 16, 8, 128), rng)
    ref = np.asarray(pc._conv5_wgrad_kl(jnp.asarray(xk.numpy()),
                                        jnp.asarray(gk.numpy()), "stem",
                                        interpret=True))
    q = c5.conv5_wgrad_stem_tc_geometry(1, 4, 8, 128)
    got = _emulate_stem_wgrad(xk, gk, q).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=5e-3 * scale, rtol=5e-3)
