"""What the CPU can hold of the tensor-copy weight-gradient kernels' software
producer (``wgrad_tma_kernel`` / ``wgrad_head_tma_kernel`` with PW > 0,
medicalseg_torch/csrc/conv5_wgrad_tma.cu), which takes the bf16 views a
tensor copy cannot describe: the gate that routes them ('ragged',
'head_ragged'), the producer's launch fields against the card's limits, a
word-level emulation of its copies (cp.async of 8 or 4 bytes with a source
size, or aligned 32-bit loads realigned with ``__byte_perm``) against the
tensor copy's boxes, and the consumer's order of summation fed by those
boxes against the plain version and the JAX package's XLA VJP. The kernels
run only on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: the boxes are compared bit for bit; the emulated weight
gradient against the plain version and the JAX f32 VJP is float32 on
bf16-representable operands, the same products summed in another order:
atol = 1e-5 of the result's magnitude, rtol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from medicalseg_tpu.ops import pallas_conv5 as pc
from medicalseg_torch.models import VNet
from medicalseg_torch.ops import conv5 as c5

SMEM_MAX = 227 * 1024
REGISTERS = 65536  # 32-bit registers of an H100 SM
ACC = 80  # f32 accumulators a consumer thread holds (25 x 32 x 32 / 320)
# The spine recipe's ragged levels at batch 3 ([N, D, H, W], Ci, Co):
# configs/mri_spine_seg/vnet_mri_spine_seg_512_512_12_15k_tpu.yml
SPINE_RAGGED = [((3, 256, 256, 9), 32, 32), ((3, 64, 64, 4), 128, 128),
                ((3, 32, 32, 2), 256, 256), ((3, 64, 64, 4), 256, 256),
                ((3, 256, 256, 9), 64, 64), ((3, 512, 512, 12), 32, 32),
                ((3, 512, 512, 12), 32, 20)]
# chip_smoke.py's RAGGED_WGRAD: the deep levels of a 96^3 V-Net, narrow heads
RAGGED_WGRAD = [((2, 12, 12, 12), 128, 128), ((2, 12, 12, 12), 256, 256),
                ((2, 6, 6, 6), 256, 256), ((2, 12, 12, 12), 32, 3),
                ((2, 12, 12, 12), 32, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# (a) the gate
# ----------------------------------------------------------------------
def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("w", [9, 12, 4, 2, 3])
@pytest.mark.parametrize("co,form", [(32, "ragged"), (20, "ragged"),
                                     (3, "head_ragged"),
                                     (16, "head_ragged")])
def test_gate_sends_ragged_rows_to_the_software_producer(w, co, form):
    x, g = _bf16((2, 3, 32, 5, w)), _bf16((2, 3, co, 5, w))
    assert c5.conv5_wgrad_form(x, g, "head") == form
    # the same extent cut from a W that is a multiple of 8: rows on 16
    # bytes, which the tensor copy reads with zeros past W
    xp, gp = _bf16((2, 3, 32, 5, 16))[..., :w], _bf16((2, 3, co, 5, 16))[
        ..., :w]
    assert c5.conv5_wgrad_form(xp, gp, "head") == form.replace("ragged",
                                                               "tma")


@pytest.mark.parametrize("co", [32, 3])
def test_gate_odd_base_and_channel_slice(co):
    tma, ragged = ("tma", "ragged") if co > 16 else ("head_tma",
                                                     "head_ragged")
    x, g = _bf16((1, 3, 40, 4, 16)), _bf16((1, 3, co, 4, 16))
    assert c5.conv5_wgrad_form(x, g, "head") == tma
    flat = _bf16(x.numel() + 1)
    odd = flat[1:].view(x.shape)
    assert c5.conv5_wgrad_form(odd, g, "head") == ragged
    assert c5.soft_vec(odd) == 0
    flat_g = _bf16(g.numel() + 1)
    assert c5.conv5_wgrad_form(x, flat_g[1:].view(g.shape), "head") == ragged
    # a channel slice at W = 12: its base 3 * 4 * 12 elements in
    wide = _bf16((1, 3, 48, 4, 12))
    sl = wide[:, :, 3:43]
    assert c5.conv5_wgrad_form(sl, _bf16((1, 3, co, 4, 12)), "head") == ragged
    assert c5.soft_vec(sl) == 8
    # f32 takes the split-TF32 kernel at any of these views
    assert c5.conv5_wgrad_form(odd.float(), g.float(), "head") == "tf32"
    assert c5.conv5_wgrad_form(sl.float(), _bf16((1, 3, co, 4, 12)).float(),
                               "head") == "tf32"


@pytest.mark.parametrize("w,vec", [(12, 8), (4, 8), (2, 4), (9, 0), (3, 0),
                                   (16, 8), (6, 4)])
def test_soft_vec_follows_the_row_alignment(w, vec):
    assert c5.soft_vec(_bf16((2, 3, 8, 5, w))) == vec


def test_spine_step_routes_eleven_ragged_weight_gradients(monkeypatch):
    """A bf16 V-Net step with the spine recipe's kernels and strides on the
    CPU, the weight-gradient wrapper recorded: the stem 'stem_tc', the four
    convs at W = 8 'tma', the eleven at W = 12, 9, 4 and 2 'ragged' (out_tr's
    32 -> 20 among them), none left to ``wgrad_mma_kernel``."""
    seen = []
    plain = c5.conv5_wgrad_kl

    def record(xk, gk, kind="head"):
        seen.append((xk.shape[4], c5.conv5_wgrad_form(xk, gk, kind)))
        return plain(xk, gk, kind)

    monkeypatch.setattr(c5, "conv5_wgrad_kl", record)
    model = VNet(num_classes=20, kernel_size=[[2, 2, 4], [2, 2, 2],
                                              [2, 2, 2], [2, 2, 2]],
                 stride_size=[[2, 2, 1], [2, 2, 1], [2, 2, 2], [2, 2, 2]],
                 dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.RandomState(4).rand(
        1, 16, 16, 12, 1).astype(np.float32))
    model(x)[0].float().sum().backward()
    forms = sorted(f for _, f in seen)
    assert forms == ["ragged"] * 11 + ["stem_tc"] + ["tma"] * 4
    assert sorted(w for w, f in seen if f == "ragged") == [
        2, 2, 4, 4, 4, 4, 4, 9, 9, 12, 12]


# ----------------------------------------------------------------------
# (b) the producer's launch fields
# ----------------------------------------------------------------------
def _check_soft(q, w, left_x, left_g):
    pws = (q["producer_warps"], q["producer_warps_realigned"])
    assert all(pw in (1, 2, 4, 6) for pw in pws)
    assert q["soft_threads"] == 32 * (10 + max(pws)) <= 1024
    # one block an SM: 80 accumulators a consumer thread and room beside
    # them within the register file's share of a thread
    regs = REGISTERS // q["soft_threads"] // 8 * 8
    assert regs >= ACC + 48 and regs <= 255
    assert q["smem"] <= SMEM_MAX
    for (c0, c1), cols, left in ((q["xspan"], q["xw"], left_x),
                                 (q["gspan"], q["gw"], left_g)):
        assert c0 % 4 == 0 and c1 % 4 == 0 and 0 <= c0 < c1 <= cols
        # a unit is 4 columns, a row at most 16 units: 16 threads
        assert (c1 - c0) // 4 <= 16
        if w > q["tw"]:
            assert (c0, c1) == (0, cols)
        else:
            # every column that holds the row; the rest are padding
            assert c0 <= left and c1 >= min(cols, left + w)
            assert c0 == left and c1 - (left + w) < 4


@pytest.mark.parametrize("shape,ci,co", SPINE_RAGGED + RAGGED_WGRAD)
def test_producer_fields_at_the_ragged_shapes(shape, ci, co):
    n, d, h, w = shape
    if co > 16:
        q = c5.conv5_wgrad_tma_geometry(n, d, h, w, ci, co)
        _check_soft(q, w, 8, 0)
    else:
        q = c5.conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co)
        _check_soft(q, w, 0, 8)


@settings(max_examples=120, deadline=None)
@given(n=st.integers(1, 3), d=st.integers(1, 40), h=st.integers(1, 70),
       w=st.integers(1, 70), ci=st.integers(2, 256), co=st.integers(1, 256))
def test_producer_fields_odd_shapes(n, d, h, w, ci, co):
    if co > 16:
        _check_soft(c5.conv5_wgrad_tma_geometry(n, d, h, w, ci, co), w, 8, 0)
    else:
        _check_soft(c5.conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co), w,
                    0, 8)


# ----------------------------------------------------------------------
# (c) the software copy, word by word
# ----------------------------------------------------------------------
class _Memory:
    """A bf16 allocation on 16 bytes as 16-bit words, a view into it at an
    element offset with its strides: what the producer reads."""

    def __init__(self, values, offset=0, pad_w=0, chans=None, c_off=0):
        n, d, c, h, w = values.shape
        cw = c if chans is None else chans
        full = np.zeros((n, d, cw, h, w + pad_w), np.float32)
        full[:, :, c_off:c_off + c, :, :w] = values
        bits = torch.from_numpy(full).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16).ravel()
        self.words16 = np.zeros(-(-(offset + bits.size) // 8) * 8 + 8,
                                np.uint16)
        self.words16[offset:offset + bits.size] = bits
        self.words32 = self.words16.view(np.uint32)
        sn, sd, sc, sh = (d * cw * h * (w + pad_w), cw * h * (w + pad_w),
                          h * (w + pad_w), w + pad_w)
        self.base = offset + c_off * sc
        self.strides = (sn, sc, sd, sh)  # n, c, d, h, as the kernel takes
        self.shape = (n, d, c, h, w)

    def view(self):
        """The view as a torch tensor with the same base parity and
        strides (for :func:`c5.soft_vec` and the gate)."""
        t = torch.from_numpy(self.words16.view(np.int16)).view(
            torch.bfloat16)
        sn, sc, sd, sh = self.strides
        return t.as_strided(self.shape, (sn, sd, sc, sh, 1), self.base)

    def values(self):
        return self.view().float()


def _byte_perm_5432(lo, hi):
    return ((lo >> 16) | ((hi & 0xFFFF) << 16)) & 0xFFFFFFFF


def _soft_box(slot, mem, vec, nb, box):
    """The producer's writes of one box into ``slot`` ([planes, rows, cols]
    uint16, kept from the stages before), as the kernel makes them: units
    of 4 columns of one row, [cs, ce) only, channels past C never
    written; 8 or 4 bytes by cp.async where ``vec`` says (the source
    aligned to them, a source size of the unit's in-range elements, the
    rest zero-filled), else the aligned 32-bit words that hold the unit
    (two where its first element is even, three where it is odd; only
    those with an element in range read) realigned with __byte_perm."""
    n_, n_d, n_c, n_h, n_w = mem.shape
    d0, ndep, c0, nch, h0, rows, w0, cols, cs, ce = box
    sn, sc, sd, sh = mem.strides
    for p in range(ndep * nch):
        dep, ch = divmod(p, nch)
        c, dd = c0 + ch, d0 + dep
        if c >= n_c:
            continue
        for r in range(rows):
            h = h0 + r
            for col in range(cs, ce, 4):
                w = w0 + col
                assert w % 4 == 0
                nw = 0 if w < 0 else max(0, min(4, n_w - w))
                n = nw if (0 <= dd < n_d and 0 <= h < n_h) else 0
                e = (mem.base + nb * sn + c * sc + dd * sd + h * sh + w
                     if n > 0 else mem.base)
                out = np.zeros(4, np.uint16)
                if vec == 8:
                    assert e % 4 == 0  # 8 bytes
                    out[:n] = mem.words16[e:e + n]
                elif vec == 4:
                    assert e % 2 == 0  # 4 bytes, twice
                    out[:min(n, 2)] = mem.words16[e:e + min(n, 2)]
                    if n > 2:
                        out[2:n] = mem.words16[e + 2:e + n]
                else:
                    odd = e % 2 == 1
                    k = e // 2
                    v = [0, 0, 0]
                    if n >= 1:
                        v[0] = int(mem.words32[k])
                    if (n >= 2) if odd else (n >= 3):
                        v[1] = int(mem.words32[k + 1])
                    if odd and n >= 4:
                        v[2] = int(mem.words32[k + 2])
                    lo = _byte_perm_5432(v[0], v[1]) if odd else v[0]
                    hi = _byte_perm_5432(v[1], v[2]) if odd else v[1]
                    halves = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
                    out[:n] = halves[:n]
                slot[p, r, col:col + 4] = out


def _tma_box(vals, nb, box):
    """The tensor copy's box: every element of the view in range, zeros
    elsewhere (f32 values of the bf16 view)."""
    d0, ndep, c0, nch, h0, rows, w0, cols, _, _ = box
    n_, n_d, n_c, n_h, n_w = vals.shape
    out = np.zeros((ndep * nch, rows, cols), np.float32)
    for dep in range(ndep):
        dd = d0 + dep
        if not 0 <= dd < n_d:
            continue
        for ch in range(min(nch, n_c - c0)):
            hs, ws = max(h0, 0), max(w0, 0)
            he, we = min(h0 + rows, n_h), min(w0 + cols, n_w)
            if he > hs and we > ws:
                out[dep * nch + ch, hs - h0:he - h0, ws - w0:we - w0] = \
                    vals[nb, dd, c0 + ch, hs:he, ws:we]
    return out


def _as_f32(slot):
    return torch.from_numpy(slot.view(np.int16)).view(
        torch.bfloat16).float().numpy()


def _tiles(n, d, h, w, th, tw):
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    for t in range(n * d * tiles_h * tiles_w):
        yield (t // (tiles_w * tiles_h * d), t // (tiles_w * tiles_h) % d,
               t // tiles_w % tiles_h * th, t % tiles_w * tw)


def _boxes_mid(q, kd, c0, o0, tile):
    """The (x, g) boxes of ``wgrad_tma_kernel`` for depth tap kd, channel
    blocks c0 / o0 and a tile (nb, od, h0, w0): Box fields as the kernel
    builds them; None where the tile's input depth is padding."""
    nb, od, h0, w0 = tile
    idd = od + kd - 2
    xb = (idd, 1, c0, 32, h0 - 2, q["xrows"], w0 - 8, q["xw"], *q["xspan"])
    gb = (od, 1, o0, 32, h0, q["grows"], w0, q["gw"], *q["gspan"])
    return xb, gb


def _boxes_head(q, c0, o0, tile):
    nb, ud, h0, w0 = tile
    xb = (ud, 1, c0, 32, h0, q["xrows"], w0, q["xw"], *q["xspan"])
    gb = (ud - 2, 5, o0, 3, h0 - 2, q["grows"], w0 - 8, q["gw"], *q["gspan"])
    return xb, gb


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (what, x [N, D, Ci, H, W] memory, Co, g memory): W = 9, 12, 4, 2, 3; a base
# one element into its allocation; a channel slice; W over several tiles
def _cases():
    out = []
    for w, co in ((9, 20), (12, 36), (4, 24), (2, 17), (3, 40), (36, 20),
                  (9, 3), (12, 16), (2, 5), (34, 3)):
        out.append(("w{}-co{}".format(w, co), dict(shape=(1, 3, 40, 6, w)),
                    co, {}, {}))
    out.append(("odd-base", dict(shape=(1, 3, 36, 6, 16)), 20,
                dict(offset=1), {}))
    out.append(("odd-base-g", dict(shape=(1, 3, 8, 6, 16)), 3, {},
                dict(offset=1)))
    out.append(("channel-slice", dict(shape=(1, 3, 36, 6, 12)), 24,
                dict(chans=44, c_off=3), dict(chans=30, c_off=5)))
    out.append(("channel-slice-head", dict(shape=(1, 3, 8, 6, 12)), 3,
                dict(offset=1), dict(chans=9, c_off=5)))
    out.append(("padded-rows", dict(shape=(1, 3, 20, 6, 9)), 20,
                dict(pad_w=3), dict(pad_w=5)))
    return out


CASES = _cases()


def _memories(case):
    what, xs, co, xkw, gkw = case
    n, d, ci, h, w = xs["shape"]
    x = _Memory(_rand((n, d, ci, h, w), ci + w), **xkw)
    g = _Memory(_rand((n, d, co, h, w), co + w + 1), **gkw)
    return x, g


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_software_copy_gives_the_tensor_copy_boxes(case):
    """Stage after stage into one ring slot (so a column or channel the
    producer skips would show a stale value): every box the producer
    fills equals, bit for bit, the box the tensor copy brings."""
    x, g = _memories(case)
    n, d, ci, h, w = x.shape
    co = g.shape[2]
    xv, gv = x.values().numpy(), g.values().numpy()
    xvec, gvec = c5.soft_vec(x.view()), c5.soft_vec(g.view())
    form = c5.conv5_wgrad_form(x.view(), g.view(), "head")
    assert form == ("ragged" if co > 16 else "head_ragged")
    head = form == "head_ragged"
    q = (c5.conv5_wgrad_head_tma_geometry if head else
         c5.conv5_wgrad_tma_geometry)(n, d, h, w, ci, co)
    tiles = list(_tiles(n, d, h, w, q["th"], q["tw"]))
    for c0 in range(0, ci, 32):
        for o0 in range(0, co, 3 if head else 32):
            xs = np.zeros((32, q["xrows"], q["xw"]), np.uint16)
            gs = np.zeros((15 if head else 32, q["grows"], q["gw"]),
                          np.uint16)
            for kd in ([0] if head else range(5)):
                for tile in tiles:
                    if head:
                        xb, gb = _boxes_head(q, c0, o0, tile)
                    else:
                        xb, gb = _boxes_mid(q, kd, c0, o0, tile)
                        if not 0 <= xb[0] < d:
                            continue  # only padding: no stage
                    _soft_box(xs, x, xvec, tile[0], xb)
                    _soft_box(gs, g, gvec, tile[0], gb)
                    np.testing.assert_array_equal(
                        _as_f32(xs), _tma_box(xv, tile[0], xb))
                    np.testing.assert_array_equal(
                        _as_f32(gs), _tma_box(gv, tile[0], gb))


def test_unaligned_reads_touch_only_words_with_an_element_in_range():
    """At W = 9 from an odd base the realigned loads read the words that
    hold the unit's elements and no word wholly outside the view: the
    allocation's first and last words are read only where they hold an
    element of it."""
    x = _Memory(_rand((1, 1, 1, 1, 9), 0), offset=1)
    assert c5.soft_vec(x.view()) == 0
    reads = []
    words = x.words32

    class Words:
        def __getitem__(self, k):
            reads.append(int(k))
            return words[k]

    x.words32 = Words()
    slot = np.zeros((1, 1, 16), np.uint16)
    _soft_box(slot, x, 0, 0, (0, 1, 0, 1, 0, 1, -4, 16, 0, 16))
    x.words32 = words
    # elements 1 .. 9 of the allocation: words 0 .. 4
    assert sorted(set(reads)) == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(
        _as_f32(slot)[0, 0, 4:13], x.values().numpy()[0, 0, 0, 0])
    assert not _as_f32(slot)[0, 0, :4].any() and not _as_f32(slot)[
        0, 0, 13:].any()


# ----------------------------------------------------------------------
# (d) the consumers fed by the software producer's boxes
# ----------------------------------------------------------------------
def _words(box):
    """bf16 box [..., cols] (f32 values) -> its 32-bit words [..., cols /
    2], element 2k in the low half."""
    u = torch.as_tensor(box).to(torch.bfloat16).view(torch.int16).to(
        torch.int64) & 0xFFFF
    return u[..., 0::2] | (u[..., 1::2] << 16)


def _halves(word):
    bits = torch.stack([word & 0xFFFF, word >> 16], -1).to(torch.int16)
    return bits.view(torch.bfloat16).float()


def _emulate_mid(x, g, q):
    """``wgrad_tma_kernel``'s arithmetic (the fragment words of the 5 kw
    taps, aligned at even shifts and byte-permuted at odd ones, one
    [25 taps, 32, 16] x [16, 32] product a K step, tiles in the split's
    order, the partials in split order) over the boxes the software
    producer fills stage after stage into one slot."""
    n, d, ci, h, w = x.shape
    co = g.shape[2]
    th, tw = q["th"], q["tw"]
    xvec, gvec = c5.soft_vec(x.view()), c5.soft_vec(g.view())
    tiles = list(_tiles(n, d, h, w, th, tw))
    per = -(-len(tiles) // q["splits"])
    k = torch.arange(16)
    half, pair, j = k // 8, k % 8 // 2, k % 2
    out = torch.zeros((5, 5, 5, ci, co))
    for c0 in range(0, ci, 32):
        for o0 in range(0, co, 32):
            for kd in range(5):
                xs = np.zeros((32, q["xrows"], q["xw"]), np.uint16)
                gs = np.zeros((32, q["grows"], q["gw"]), np.uint16)
                parts = []
                for s in range(q["splits"]):
                    acc = torch.zeros((5, 5, 32, 32))
                    for tile in tiles[s * per:(s + 1) * per]:
                        xb, gb = _boxes_mid(q, kd, c0, o0, tile)
                        if not 0 <= xb[0] < d:
                            continue
                        _soft_box(xs, x, xvec, tile[0], xb)
                        _soft_box(gs, g, gvec, tile[0], gb)
                        xw, gw = _words(_as_f32(xs)), _words(_as_f32(gs))
                        steps = ([(row, ws) for row in range(th)
                                  for ws in range(0, tw, 16)]
                                 if tw >= 16 else
                                 [(row, 0) for row in range(0, th, 2)])
                        for row, ws in steps:
                            if tw >= 16:
                                rows, col = row + 0 * half, ws // 2 + \
                                    4 * half + pair
                            else:
                                rows, col = row + half, pair
                            b = _halves(gw[:, rows, col])[:, k, j]
                            a = torch.empty((5, 5, 32, 16))
                            for kh in range(5):
                                base = xw[:, rows + kh, col + 3]
                                nxt = xw[:, rows + kh, col + 4]
                                last = xw[:, rows + kh, col + 5]
                                taps = [base, _byte_perm_5432(base, nxt), nxt,
                                        _byte_perm_5432(nxt, last), last]
                                for kw in range(5):
                                    a[kh, kw] = _halves(taps[kw])[:, k, j]
                            acc += a @ b.t()
                    parts.append(acc)
                tot = parts[0]
                for part in parts[1:]:
                    tot = tot + part
                ce, oe = min(ci - c0, 32), min(co - o0, 32)
                out[kd, :, :, c0:c0 + ce, o0:o0 + oe] = tot[:, :, :ce, :oe]
    return out


def _emulate_head(x, g, q):
    """``wgrad_head_tma_kernel``'s arithmetic over the software producer's
    boxes: dW[kd, kh, kw, ci, co] = sum over u of x[ci, u] * g[co, u - tap
    + 2], the taps on g read from the g box [5 d][3 co][rows][cols] (8
    columns left of the tile), one [32, 16] x [16] K step of 16 w of a
    row at a time, the two row parities summed apart and added in order,
    the partials in split order."""
    n, d, ci, h, w = x.shape
    co = g.shape[2]
    th, tw = q["th"], q["tw"]
    xvec, gvec = c5.soft_vec(x.view()), c5.soft_vec(g.view())
    tiles = list(_tiles(n, d, h, w, th, tw))
    per = -(-len(tiles) // q["splits"])
    out = torch.zeros((5, 5, 5, ci, co))
    for c0 in range(0, ci, 32):
        for o0 in range(0, co, 3):
            xs = np.zeros((32, q["xrows"], q["xw"]), np.uint16)
            gs = np.zeros((15, q["grows"], q["gw"]), np.uint16)
            parts = []
            for s in range(q["splits"]):
                acc = torch.zeros((2, 5, 5, 5, 32, 3))  # [row parity, ...]
                for tile in tiles[s * per:(s + 1) * per]:
                    xb, gb = _boxes_head(q, c0, o0, tile)
                    _soft_box(xs, x, xvec, tile[0], xb)
                    _soft_box(gs, g, gvec, tile[0], gb)
                    xf = torch.from_numpy(_as_f32(xs))
                    gf = torch.from_numpy(_as_f32(gs)).view(
                        5, 3, q["grows"], q["gw"])
                    for row in range(th):
                        for ws in range(0, tw, 16):
                            a = xf[:, row, ws:ws + 16]  # [32, 16]
                            for kd in range(5):
                                for kh in range(5):
                                    for kw in range(5):
                                        bg = gf[4 - kd, :, row + 4 - kh,
                                                ws + 10 - kw:ws + 26 - kw]
                                        acc[row % 2, kd, kh, kw] += a @ bg.t()
                parts.append(acc[0] + acc[1])
            tot = parts[0]
            for part in parts[1:]:
                tot = tot + part
            ce, oe = min(ci - c0, 32), min(co - o0, 3)
            out[:, :, :, c0:c0 + ce, o0:o0 + oe] = tot[..., :ce, :oe]
    return out


CONSUMER_CASES = [c for c in CASES if c[0] in (
    "w9-co20", "w4-co24", "w2-co17", "w36-co20", "odd-base", "channel-slice",
    "w9-co3", "w12-co16", "odd-base-g", "channel-slice-head")]


@pytest.mark.parametrize("case", CONSUMER_CASES,
                         ids=[c[0] for c in CONSUMER_CASES])
def test_emulated_kernel_on_software_boxes_equals_plain_and_jax(case):
    x, g = _memories(case)
    n, d, ci, h, w = x.shape
    co = g.shape[2]
    if co > 16:
        q = c5.conv5_wgrad_tma_geometry(n, d, h, w, ci, co)
        got = _emulate_mid(x, g, q)
    else:
        q = c5.conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co)
        got = _emulate_head(x, g, q)
    xt, gt = x.values(), g.values()
    ref = c5.conv5_wgrad_kl_plain(xt.contiguous(), gt.contiguous())
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)
    # the JAX package's gradient of the same conv: at these W it is XLA's
    # VJP of its stock conv, in f32
    jx, jg = jnp.asarray(xt.numpy()), jnp.asarray(gt.numpy())
    k0 = jnp.zeros((5, 5, 5, ci, co), jnp.float32)
    b0 = jnp.zeros((co,), jnp.float32)
    jdw = jax.grad(lambda k: jnp.vdot(pc._conv5_xla_kl(jx, k, b0), jg))(k0)
    torch.testing.assert_close(got, torch.from_numpy(np.array(jdw)),
                               atol=1e-5 * scale, rtol=1e-5)
