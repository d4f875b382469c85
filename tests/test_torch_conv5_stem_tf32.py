"""What the CPU can hold of the float32 stem's split-TF32 kernels
(medicalseg_torch/csrc/conv5_stem_tf32.cu ``stem_tf32_kernel``, forward and
fused forward; csrc/conv5_stem_wgrad_tf32.cu ``stem_wgrad_tf32_kernel``,
the weight gradient; medicalseg_torch/ops/conv5.py): the launch geometry of
both at the cube's stem, the upstream spine recipes' stem (W = 12), a
halo'd H block and odd shapes; the pre-split packed weights and their
cache; the gate and the views it takes; an f32 V-Net step's stem routes;
the banks the kernels' operand loads hit; and each kernel's order of
summation emulated in plain PyTorch (tap order, split products, stage
accumulators, warp and block order). The kernels themselves run only on
the card (tests/test_torch_cuda.py and chip_smoke.py hold them to the
plain versions there).

Tolerances: the emulations against the plain versions are f32 sums of the
same products to about 2^-22 each, in another order: atol = rtol = 1e-5
(the weight gradient relative to the tensor's magnitude, as chip_smoke's
``scaled_err``). Against the JAX package's Pallas stem and stem weight
gradient (interpret mode, f32) atol = rtol = 1e-4, the f32 tolerance
chip_smoke holds the kernels to. One TF32 product a term (hi*hi) misses
1e-4.
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
def _check_fwd(n, d, h, w):
    q = c5.conv5_stem_tf32_geometry(n, d, h, w)
    th, twd, tiles_w = q["th"], q["twd"], q["tiles_w"]
    # the tile: at most 512 voxels (8 warps x 4 m16 tiles), whole rows
    # where W fits 64 columns, else tiles of a multiple of 4 columns
    assert 1 <= th <= h and th * twd <= 512
    assert (tiles_w, twd) == (1, w) if w <= 64 else (
        twd % 4 == 0 and twd <= 64 and tiles_w * twd >= w >
        (tiles_w - 1) * twd)
    assert q["rawp"] % 4 == 0 and q["rawp"] >= twd + 6
    # the least pitches with rowp = 8 mod 16 and slot = 8 mod 32
    assert twd + 4 <= q["rowp"] < twd + 20 and q["rowp"] % 16 == 8
    assert (th + 4) * q["rowp"] <= q["slot"] < (th + 4) * q["rowp"] + 32
    assert q["slot"] % 32 == 8
    smem = (16 * 16 * 2 * 32 + 4 * (8 * 16 * 68 + (th + 4) * q["rawp"] + 64 +
                                    10 * q["slot"]))
    assert q["smem"] == smem <= SMEM_MAX
    assert q["blocks_per_sm"] == (2 if 2 * smem <= SMEM_MAX else 1)
    assert q["chunks"] * q["dc"] >= d > (q["chunks"] - 1) * q["dc"]
    assert q["grid"] == (-(-h // th) * tiles_w, n * q["chunks"])
    assert q["grid"][0] < 2 ** 31 and q["grid"][1] <= 65535
    return q


def _check_wgrad(n, d, h, w):
    q = c5.conv5_wgrad_stem_tf32_geometry(n, d, h, w)
    th, twd, tiles_w = q["th"], q["twd"], q["tiles_w"]
    assert 1 <= th <= h and th * twd <= 256
    assert (tiles_w, twd) == (1, w) if w <= 32 else (
        twd % 4 == 0 and twd <= 32 and tiles_w * twd >= w >
        (tiles_w - 1) * twd)
    assert q["tiles"] == -(-h // th) * tiles_w
    # the ring's pitches put a B load's eight windows on distinct banks
    assert (q["rowp"] % 32, q["slot"] % 32) == ((4, 20), (20, 4))[q["order"]]
    assert q["rowp"] >= twd + 4 and q["slot"] >= (th + 4) * q["rowp"]
    assert q["smem"] == 4 * (3 * 16 * 260 + 3 * (th + 4) * q["rawp"] +
                             20 * q["slot"] + 8 * 256) <= SMEM_MAX
    resident = q["blocks_per_sm"] * SMS
    assert q["chunks"] * q["dc"] >= d > (q["chunks"] - 1) * q["dc"]
    assert q["items"] == n * q["chunks"] * q["tiles"]
    assert q["blocks"] * q["per"] >= q["items"] > (q["blocks"] - 1) * q["per"]
    assert q["grid"] == (q["blocks"],) and q["blocks"] <= resident
    return q


def test_geometry_cube_stem():
    """in_tr of the upstream lung recipe, 2 x 128^3: the forward's 8 x 64
    tiles over 4 depth chunks (one wave of 256 blocks, two an SM), the
    weight gradient's 8 x 32 tiles over 2 depth chunks of 64."""
    q = _check_fwd(2, 128, 128, 128)
    assert (q["th"], q["twd"], q["tiles_w"], q["dc"]) == (8, 64, 2, 32)
    assert q["grid"] == (32, 8) and q["blocks_per_sm"] == 2
    q = _check_wgrad(2, 128, 128, 128)
    assert (q["th"], q["twd"], q["dc"], q["items"], q["blocks"]) == (
        8, 32, 64, 256, 256)


def test_geometry_spine_stem():
    """in_tr of the upstream spine recipes, [3, 512, 1, 512, 12]: whole
    rows of 12 (no padded column), 40 rows a forward tile (480 voxels),
    21 a weight-gradient tile (252)."""
    q = _check_fwd(3, 512, 512, 12)
    assert (q["th"], q["twd"], q["tiles_w"]) == (40, 12, 1)
    assert q["blocks_per_sm"] == 2
    q = _check_wgrad(3, 512, 512, 12)
    assert (q["th"], q["twd"], q["tiles"]) == (21, 12, 25)
    assert q["blocks_per_sm"] == 2


@pytest.mark.parametrize("n,d,h,w", [(2, 128, 68, 128), (3, 512, 260, 12),
                                     (1, 128, 9, 128)])
def test_geometry_halo_h_blocks(n, d, h, w):
    """A space rank's block with its 2 + 2 halo rows (H / S + 4: the cube
    and the spine stem over S = 2, a long window)."""
    _check_fwd(n, d, h, w)
    _check_wgrad(n, d, h, w)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 3), d=st.integers(1, 300), h=st.integers(1, 600),
       w=st.integers(1, 600))
def test_geometry_odd_shapes(n, d, h, w):
    _check_fwd(n, d, h, w)
    _check_wgrad(n, d, h, w)


def _wgrad_columns(order):
    """The N columns of ``stem_wgrad_tf32_kernel`` as its ``col_tap`` lays
    them out: column 8 j + i -> (kd, kh, kw), or None for the three
    padding columns. n8 tiles 0..14: kw = j // 3 and rows r = 1 + 8 (j %
    3) + i, r = 5 kd + kh (``order`` 0) or kd + 5 kh (1); tile 15: row 0
    of kw 0..4."""
    cols = []
    for j in range(16):
        for i in range(8):
            if j < 15:
                r = 1 + 8 * (j % 3) + i
                kd, kh = (r % 5, r // 5) if order else divmod(r, 5)
                cols.append((kd, kh, j // 3))
            else:
                cols.append((0, 0, i) if i < 5 else None)
    return cols


def _wgrad_b_wavefronts(rowp, slot, order):
    """Wavefronts of the weight gradient's 16 B loads of a k8 step (one
    plane): lane (i, t) of n8 tile j reads word t + kd slot + kh rowp + kw
    of column 8 j + i (padding columns read tap (0, 0, 0)'s word)."""
    cols = [c or (0, 0, 0) for c in _wgrad_columns(order)]

    def word(j, lane):
        kd, kh, kw = cols[8 * j + lane // 4]
        return kd * slot + kh * rowp + kw + lane % 4

    return int(_wavefronts([[word(j, lane) for lane in range(32)]
                            for j in range(16)]).sum())


# ----------------------------------------------------------------------
# (b) the packed weights and their cache
# ----------------------------------------------------------------------
def test_columns_cover_every_tap_once():
    fwd = [c for c in c5.stem_tf32_columns() if c is not None]
    taps = [(kd, kh, kw) for kd in range(5) for kh in range(5)
            for kw in range(5)]
    assert len(c5.stem_tf32_columns()) == 128 and sorted(fwd) == taps
    for order in (0, 1):
        cols = _wgrad_columns(order)
        assert len(cols) == 128
        assert sorted(c for c in cols if c is not None) == taps


def _unpack(packed):
    """The kernel's B fragments back to (hi, lo), each [128 columns, 16
    channels]: lane (g, t) of n8 tile f at k step s holds column 8 s + t
    (+ 4) of channel 8 f + g."""
    # [s, f, g, t, hl, half] -> [hl, s, half, t, f, g]
    w = packed.reshape(16, 2, 8, 4, 2, 2).permute(4, 0, 5, 3, 1, 2)
    return w.reshape(2, 128, 16).unbind(0)


@pytest.mark.parametrize("co", [16, 5, 1])
def test_packed_weights_round_trip(co):
    rng = np.random.RandomState(co)
    w = torch.from_numpy(rng.randn(5, 5, 5, 1, co).astype(np.float32))
    packed = c5._pack_weights_stem_tf32(w)
    assert packed.shape == (16, 2, 32, 4) and packed.dtype == torch.float32
    hi, lo = _unpack(packed)
    for col, tap in enumerate(c5.stem_tf32_columns()):
        if tap is None:
            assert hi[col].abs().sum() == 0 and lo[col].abs().sum() == 0
            continue
        want_hi, want_lo = c5.split_tf32(w[tap][0])
        assert torch.equal(hi[col, :co], want_hi)
        assert torch.equal(lo[col, :co], want_lo)
    assert hi[:, co:].abs().sum() == 0 and lo[:, co:].abs().sum() == 0


def test_packed_weight_cached_per_form():
    """The f32 stem's packing is an entry of the parameter's cache beside
    the bf16 stem's, rebuilt after an in-place update."""
    p = torch.nn.Parameter(torch.randn((16, 1, 5, 5, 5),
                                       generator=torch.Generator(
                                       ).manual_seed(1)))
    view = p.permute(2, 3, 4, 1, 0)
    first = c5._packed_weight(view, "stem_tf32")
    assert c5._packed_weight(view, "stem_tf32") is first
    assert torch.equal(first, c5._pack_weights_stem_tf32(view.detach()))
    assert c5._packed_weight(view, "stem") is not first
    with torch.no_grad():
        p.mul_(2.0)
    again = c5._packed_weight(view, "stem_tf32")
    assert again is not first
    assert torch.equal(again, c5._pack_weights_stem_tf32(view.detach()))


# ----------------------------------------------------------------------
# (c) the gate
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,co,fwd,wgrad", [
    (torch.float32, 16, "stem_tf32", "stem_tf32"),
    (torch.float32, 1, "stem_tf32", "stem_tf32"),
    (torch.float32, 17, "stem", "stem"),
    (torch.bfloat16, 16, "stem_tc", "stem_tc"),
    (torch.bfloat16, 17, "stem", "stem")])
def test_gate_forms(dtype, co, fwd, wgrad):
    x = torch.empty((2, 4, 1, 8, 12), dtype=dtype, device="meta")
    g = torch.empty((2, 4, co, 8, 12), dtype=dtype, device="meta")
    assert c5.conv5_form(x, co, "stem") == fwd
    assert c5.conv5_wgrad_form(x, g, "stem") == wgrad


def test_gate_takes_ragged_views():
    """The kernels copy by 4 bytes with zero fill where a view's base or
    strides are not on 16 bytes: W = 13 rows, a base 4 bytes into an
    allocation, a channel slice, an H block behind a 2-row halo all stay
    on the split-TF32 stem kernels."""
    x = torch.zeros((1, 3, 1, 9, 13))
    flat = torch.zeros(x.numel() + 1)
    wide = torch.zeros((1, 3, 4, 9, 13))
    g = torch.zeros((1, 3, 16, 9, 13))
    gflat = torch.zeros(g.numel() + 1)
    gwide = torch.zeros((1, 3, 20, 9, 13))
    for xv in (x, flat[1:].view(x.shape), wide[:, :, 2:3],
               F.pad(x, (0, 0, 2, 2))):
        assert c5.conv5_form(xv, 16, "stem") == "stem_tf32"
        for gv in (gflat[1:].view(g.shape), gwide[:, :, 3:19]):
            if gv.shape[3] == xv.shape[3]:
                assert c5.conv5_wgrad_form(xv, gv, "stem") == "stem_tf32"


def test_f32_vnet_step_hands_the_stem_to_the_new_kernels(monkeypatch):
    """An f32 V-Net forward and backward on the CPU, the wrappers recorded:
    the stem's forward is 'stem_tf32' and so is its weight gradient; no
    other conv takes a stem form."""
    seen = []
    fwd, wgrad = c5._conv5_forward, c5.conv5_wgrad_kl

    def record(xk, w, b, kind):
        seen.append(("fwd", kind, c5.conv5_form(xk, w.shape[4], kind)))
        return fwd(xk, w, b, kind)

    def record_w(xk, gk, kind="head"):
        seen.append(("wgrad", kind, c5.conv5_wgrad_form(xk, gk, kind)))
        return wgrad(xk, gk, kind)

    monkeypatch.setattr(c5, "_conv5_forward", record)
    monkeypatch.setattr(c5, "conv5_wgrad_kl", record_w)
    model = VNet(num_classes=2, generator=torch.Generator().manual_seed(8))
    x = torch.from_numpy(np.random.RandomState(9).rand(
        1, 16, 16, 16, 1).astype(np.float32))
    model(x)[0].sum().backward()
    stems = [s for s in seen if s[1] == "stem"]
    assert stems == [("fwd", "stem", "stem_tf32"),
                     ("wgrad", "stem", "stem_tf32")]
    assert all(f.startswith("head") or f == "tf32" for _, k, f in seen
               if k != "stem")


# ----------------------------------------------------------------------
# (d) the banks of the operand loads
# ----------------------------------------------------------------------
def _wavefronts(words):
    """Shared-memory wavefronts of warp loads: ``words`` [R, 32] int, the
    32-bit word each lane reads; per row the most distinct words that fall
    on one of the 32 banks."""
    words = np.sort(np.asarray(words, dtype=np.int64), axis=1)
    new = np.ones(words.shape, dtype=bool)
    new[:, 1:] = words[:, 1:] != words[:, :-1]
    rows = np.broadcast_to(np.arange(words.shape[0])[:, None], words.shape)
    count = np.bincount((rows * 32 + words % 32)[new],
                        minlength=32 * words.shape[0])
    return count.reshape(-1, 32).max(axis=1)


def _fwd_a_wavefronts(th, twd, rowp, slot):
    """The wavefronts and loads of ``stem_tf32_kernel``'s A loads over one
    depth of a whole th x twd tile (one plane; hi and lo alike): per m16
    tile and A register, the 25 kw quads (lane (g, t) reads vo(g) + t), the
    5 kh quads (vo(g) + t rowp), the kd quad (vo(g) + the slot of depth tap
    t, its worst ring position) and the lone tap (vo(g)), with vo(v) =
    (v // twd) rowp + v % twd the word of voxel v (0 past the tile).
    Returns (wavefronts, loads)."""
    tvox = th * twd
    v = (16 * np.arange(-(-tvox // 16))[:, None, None] +
         8 * np.arange(2)[None, :, None] + np.arange(32)[None, None, :] // 4)
    vo = np.where(v < tvox, (v // twd) * rowp + v % twd, 0).reshape(-1, 32)
    t = np.arange(32) % 4
    parts = [vo + t, vo + t * rowp, vo] + [vo + ((b + t) % 5) * slot
                                           for b in range(5)]
    fronts = _wavefronts(np.concatenate(parts)).reshape(len(parts), -1).sum(1)
    total = 25 * fronts[0] + 5 * fronts[1] + fronts[2] + fronts[3:].max()
    return int(total), 32 * vo.shape[0]


def _half_words(hg, t, slots, rowp):
    """The kernel's half_offset: lane quad position t's ring word at half
    k8 step hg, from the slots of depth taps 0..4."""
    if hg < 25:
        return slots[hg // 5] + (hg % 5) * rowp + t
    if hg < 30:
        return slots[hg - 25] + t * rowp + 4
    if hg == 30:
        return slots[t] + 4 * rowp + 4
    return slots[4] + 4 * rowp + 4


@pytest.mark.parametrize("base", range(5))
def test_forward_offsets_read_the_columns_taps(base):
    """Every K column's word (half_offset, a ring position ``base``) is the
    word of its tap (kd, kh, kw): slot of input depth od - 2 + kd, row kh,
    column kw; the zero-weight columns read the tap (4, 4, 4)."""
    q = c5.conv5_stem_tf32_geometry(3, 512, 512, 12)
    slots = [((base + kd) % 5) * q["slot"] for kd in range(5)]
    for col, tap in enumerate(c5.stem_tf32_columns()):
        kd, kh, kw = tap or (4, 4, 4)
        assert _half_words(col // 4, col % 4, slots, q["rowp"]) == (
            slots[kd] + kh * q["rowp"] + kw)


@pytest.mark.parametrize("shape,most", [((2, 128, 128, 128), 1.04),
                                        ((3, 512, 512, 12), 1.10)])
def test_forward_a_loads_spread_over_the_banks(shape, most):
    """A warp's A loads of a depth, summed over the tile: at the cube's 8 x
    64 tile only the kd quad (1 of 32 half k steps) meets a second
    wavefront where the ring's first and fifth slots are both read; at the
    spine's whole rows of 12 the chosen row pitch keeps it under 10%."""
    q = c5.conv5_stem_tf32_geometry(*shape)
    fronts, loads = _fwd_a_wavefronts(q["th"], q["twd"], q["rowp"],
                                      q["slot"])
    assert loads <= fronts <= most * loads


@pytest.mark.parametrize("shape", [(2, 128, 128, 128), (3, 512, 512, 12),
                                   (2, 128, 68, 128), (1, 64, 96, 100),
                                   (1, 6, 11, 200), (2, 4, 9, 40)])
def test_forward_row_pitch_rule_reaches_the_fewest_wavefronts(shape):
    """The geometry's row pitch (the least that is 8 mod 16) loads A in as
    few wavefronts as any of the 32 pitches from twd + 4, each with its
    least slot that is 8 mod 32."""
    q = c5.conv5_stem_tf32_geometry(*shape)
    th, twd = q["th"], q["twd"]

    def fronts(rowp):
        lo = (th + 4) * rowp
        return _fwd_a_wavefronts(th, twd, rowp, lo + (8 - lo) % 32)[0]

    assert fronts(q["rowp"]) == min(fronts(r) for r in range(
        twd + 4, twd + 36))


@pytest.mark.parametrize("shape", [(2, 128, 128, 128), (3, 512, 512, 12),
                                   (2, 128, 68, 128), (1, 3, 5, 7)])
def test_wgrad_b_loads_spread_over_the_banks(shape):
    """Per n8 tile a warp loads lane (i, t)'s word t + offset(8 j + i): 16
    wavefronts for the 16 tiles (conflict-free) with the geometry's tap
    order and pitches; the A loads (g: channel i, word t, 260-word channel
    pitch) are conflict-free."""
    q = c5.conv5_wgrad_stem_tf32_geometry(*shape)
    assert _wgrad_b_wavefronts(q["rowp"], q["slot"], q["order"]) == 16
    for base in (0, 4):
        words = [[(lane // 4) * 260 + base + lane % 4 for lane in range(32)]]
        assert _wavefronts(words).tolist() == [1]


# ----------------------------------------------------------------------
# (e) the kernels' order of summation, emulated
# ----------------------------------------------------------------------
def _emulate_fwd(xk, w, b, ep, split=True):
    """``stem_tf32_kernel`` in plain PyTorch: the packed pre-split weights,
    the input split per value, per voxel the 16 k8 steps of the columns of
    :func:`c5.stem_tf32_columns`, each adding lo*hi, hi*lo and hi*hi in
    that order to one f32 accumulator, then bias and epilogue.
    ``split=False``: one TF32 product (hi*hi) a term."""
    n, d, _, h, ww = xk.shape
    co = w.shape[4]
    bh, bl = _unpack(c5._pack_weights_stem_tf32(w))
    xh, xl = c5.split_tf32(F.pad(xk[:, :, 0].float(), (2, 2, 2, 2, 2, 2)))
    taps = [c or (4, 4, 4) for c in c5.stem_tf32_columns()]

    def gather(t):  # [n, d, h, w, 128]: x at voxel + tap of each column
        return torch.stack([t[:, kd:kd + d, kh:kh + h, kw:kw + ww]
                            for kd, kh, kw in taps], -1)

    ah, al = gather(xh), gather(xl)
    acc = torch.zeros((n, d, h, ww, 16))
    for s in range(16):
        c = slice(8 * s, 8 * s + 8)
        if split:
            acc = acc + al[..., c] @ bh[c]
            acc = acc + ah[..., c] @ bl[c]
        acc = acc + ah[..., c] @ bh[c]
    out = acc[..., :co].permute(0, 1, 4, 2, 3) + b.reshape(1, 1, -1, 1, 1)
    if ep is not None:
        inv, shift, alpha = (v.reshape(1, 1, -1, 1, 1) for v in ep)
        out = out * inv + shift
        out = torch.where(out >= 0, out, out * alpha)
    return out.contiguous()


def _items(q, n, h, d):
    """The work items of each block as the kernel walks them: [(nb, h0,
    w0, d0, d1), ...] per block."""
    tiles_h = q["tiles"] // q["tiles_w"]
    out = []
    for blk in range(q["blocks"]):
        items = []
        for it in range(blk * q["per"], min(q["items"], (blk + 1) * q["per"])):
            tile, rest = it % q["tiles"], it // q["tiles"]
            chunk, nb = rest % q["chunks"], rest // q["chunks"]
            assert tile // q["tiles_w"] < tiles_h
            d0 = chunk * q["dc"]
            items.append((nb, tile // q["tiles_w"] * q["th"],
                          tile % q["tiles_w"] * q["twd"], d0,
                          min(d, d0 + q["dc"])))
        out.append(items)
    return out


def _emulate_wgrad(xk, gk, split=True):
    """``stem_wgrad_tf32_kernel`` in plain PyTorch: per block its items in
    order, per item and output depth the tile's 256 voxel slots (row-major
    over th x twd; g zero past the volume and Co), x at each slot + the tap
    of each N column (:func:`_wgrad_columns`); per warp
    (voxels 32 i ..) and stage (two k8 steps of 8 voxels) a fresh sum of
    lo*hi, hi*lo and hi*hi per k step in that order, added to the warp's
    running f32 sums (a stage past the tile's voxels skipped); the warps'
    sums added in warp order, the blocks' partials in block order.
    ``split=False``: hi*hi alone. Returns f32 [5, 5, 5, 1, Co]."""
    n, d, _, h, w = xk.shape
    co = gk.shape[2]
    q = c5.conv5_wgrad_stem_tf32_geometry(n, d, h, w)
    th, twd = q["th"], q["twd"]
    hp, wp = -(-h // th) * th, q["tiles_w"] * twd
    xp = F.pad(xk[:, :, 0].float(), (2, wp - w + 2, 2, hp - h + 2, 2, 2))
    gp = F.pad(gk.float(), (0, wp - w, 0, hp - h, 0, 16 - co))
    taps = [c or (0, 0, 0) for c in _wgrad_columns(q["order"])]
    v = torch.arange(256)
    r, c = v // twd, v % twd
    total = None
    for items in _items(q, n, h, d):
        run = torch.zeros((8, 16, 128))
        for nb, h0, w0, d0, d1 in items:
            tvox = min(th, h - h0) * twd
            inside = (v < tvox)
            rr, cc = r.clamp(max=th - 1), c
            for od in range(d0, d1):
                gv = gp[nb, od][:, h0 + rr, w0 + cc] * inside  # [16, 256]
                xv = torch.stack([xp[nb, od + kd, h0 + rr + kh, w0 + cc + kw]
                                  for kd, kh, kw in taps], -1)  # [256, 128]
                gh, gl = c5.split_tf32(gv)
                xh, xl = c5.split_tf32(xv)
                for st in range(2):
                    s = torch.zeros((8, 16, 128))
                    for k in range(2):
                        vs = (torch.arange(8)[:, None] * 32 + 16 * st + 8 * k +
                              torch.arange(8)[None, :])  # [warp, 8 voxels]
                        a_h = gh[:, vs].permute(1, 0, 2)
                        a_l = gl[:, vs].permute(1, 0, 2)
                        b_h, b_l = xh[vs], xl[vs]
                        if split:
                            s = s + a_l @ b_h
                            s = s + a_h @ b_l
                        s = s + a_h @ b_h
                    live = (torch.arange(8) * 32 + 16 * st < tvox)
                    run = torch.where(live[:, None, None], run + s, run)
        part = run[0]
        for wp_ in range(1, 8):
            part = part + run[wp_]
        total = part if total is None else total + part
    dw = torch.zeros((5, 5, 5, 1, co))
    for col, tap in enumerate(_wgrad_columns(q["order"])):
        if tap is not None:
            dw[tap][0] = total[:co, col]
    return dw


def _data(n, d, h, w, co, seed):
    rng = np.random.RandomState(seed)
    xk = torch.from_numpy(rng.rand(n, d, 1, h, w).astype(np.float32))
    k = torch.from_numpy((rng.randn(5, 5, 5, 1, co) / np.sqrt(125)).astype(
        np.float32))
    b = torch.from_numpy(rng.randn(co).astype(np.float32))
    ep = tuple(torch.from_numpy(v.astype(np.float32)) for v in (
        0.5 + rng.rand(co), rng.randn(co), rng.rand(co)))
    g = torch.from_numpy(rng.randn(n, d, co, h, w).astype(np.float32))
    return xk, k, b, ep, g


def _scaled_err(got, ref):
    return ((got - ref).abs() / (ref.abs().max() + ref.abs())).max().item()


# W < 16 with D < 5 and H < 8 (whole rows), W over several weight-gradient
# tiles, Co < 16, the spine stem's rows of 12 with a short last tile and
# warps past the tile's voxels, W over several forward tiles
SHAPES = [(1, 3, 5, 7, 16), (2, 2, 9, 40, 16), (1, 4, 3, 20, 5),
          (1, 3, 30, 12, 16), (1, 2, 4, 70, 16)]


@pytest.mark.parametrize("n,d,h,w,co", SHAPES)
@pytest.mark.parametrize("fused", [False, True])
def test_emulated_forward_equals_plain(n, d, h, w, co, fused):
    xk, k, b, ep, _ = _data(n, d, h, w, co, seed=d + h + w + co)
    ep = ep if fused else None
    torch.testing.assert_close(_emulate_fwd(xk, k, b, ep),
                               c5.conv5_kl_plain(xk, k, b, ep),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,h,w,co", SHAPES)
def test_emulated_wgrad_equals_plain(n, d, h, w, co):
    xk, _, _, _, g = _data(n, d, h, w, co, seed=3 * d + h + w + co)
    assert _scaled_err(_emulate_wgrad(xk, g),
                       c5.conv5_wgrad_kl_plain(xk, g)) <= 1e-5


def test_emulated_wgrad_blocks_and_items():
    """Many depths over few tiles: several blocks, each walking items of
    depth chunks, their partials added in block order; the same bits
    twice."""
    xk, _, _, _, g = _data(1, 24, 6, 12, 16, seed=5)
    q = c5.conv5_wgrad_stem_tf32_geometry(1, 24, 6, 12)
    assert q["blocks"] > 1 and q["chunks"] > 1
    got = _emulate_wgrad(xk, g)
    assert torch.equal(got, _emulate_wgrad(xk, g))
    assert _scaled_err(got, c5.conv5_wgrad_kl_plain(xk, g)) <= 1e-5


@pytest.mark.parametrize("fused", [False, True])
def test_emulated_kernels_match_pallas_interpret(fused):
    """Against the JAX package's stem (the Pallas kernel, interpret mode,
    f32, with and without its fused epilogue) and its stem weight gradient,
    the same numpy-seeded operands moved across."""
    xk, k, b, ep, g = _data(1, 4, 8, 128, 16, seed=30 + fused)
    jx, jk, jb, jg = (jnp.asarray(t.numpy()) for t in (xk, k, b, g))
    ep = ep if fused else None
    ref = np.asarray(pc._conv5_stem_kl(
        jx, jk, jb, interpret=True,
        ep=None if ep is None else tuple(jnp.asarray(v.numpy()) for v in ep)))
    np.testing.assert_allclose(_emulate_fwd(xk, k, b, ep).numpy(), ref,
                               atol=1e-4, rtol=1e-4)
    if fused:
        return
    dw = np.asarray(pc._conv5_wgrad_kl(jx, jg, "stem", interpret=True))
    np.testing.assert_allclose(_emulate_wgrad(xk, g).numpy(), dw,
                               atol=1e-4 * np.abs(dw).max(), rtol=1e-4)


def test_one_tf32_product_misses_the_f32_tolerance():
    """The same emulations with one TF32 product a term (hi*hi) miss atol =
    rtol = 1e-4 against the plain versions, where the split holds it (and
    the weight gradient 1e-5 scaled)."""
    xk, k, b, _, g = _data(1, 3, 8, 16, 16, seed=41)
    ref = c5.conv5_kl_plain(xk, k, b)
    assert not torch.allclose(_emulate_fwd(xk, k, b, None, split=False), ref,
                              atol=1e-4, rtol=1e-4)
    assert torch.allclose(_emulate_fwd(xk, k, b, None), ref, atol=1e-4,
                          rtol=1e-4)
    ref_w = c5.conv5_wgrad_kl_plain(xk, g)
    assert _scaled_err(_emulate_wgrad(xk, g, split=False), ref_w) > 1e-4
    assert _scaled_err(_emulate_wgrad(xk, g), ref_w) <= 1e-5
