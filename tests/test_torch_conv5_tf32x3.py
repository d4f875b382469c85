"""What the CPU can hold of the float32 conv5 kernels on the tensor cores
(split TF32: csrc/conv5_tf32.cu ``conv5_tf32_kernel`` for the forward, the
fused forward and the input gradient, csrc/conv5_wgrad_tf32.cu
``wgrad_tf32_kernel`` for the weight gradient; medicalseg_torch/ops/
conv5.py): the split of an f32 value into two TF32 halves, the launch
geometry of both kernels at the cube's and the spine recipes' shapes and at
a halo'd H block, the pre-split packed weights and their cache, the forms
gate, and the kernels' order of summation emulated in plain PyTorch. The
kernels themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them to the plain versions there).

Tolerances: the emulation against the plain versions is f32 sums of the
same products to about 2^-22 each, in another order: atol = rtol = 1e-5
(the weight gradient relative to the tensor's magnitude, as chip_smoke's
``scaled_err``). Against the JAX package's Pallas kernels (interpret mode
on the CPU, as tests/test_torch_conv5_hopper.py runs them) atol = rtol =
1e-4, the f32 tolerance chip_smoke holds the kernels to. One TF32 product
alone (10 mantissa bits an operand) misses 1e-4: the split is needed.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from medicalseg_tpu.ops import pallas_conv5 as pc
from medicalseg_torch.models import VNet
from medicalseg_torch.ops import conv5 as c5

SMEM_MAX = 227 * 1024
SMS = 132
# (Ci, Co, edge) of the f32 head convs of one V-Net pass at 128^3 (the
# upstream lung recipe: 15 of them)
CUBE_CONVS = [(32, 32, 64), (64, 64, 32), (128, 128, 16), (256, 256, 8),
              (256, 256, 16), (128, 128, 32), (64, 64, 64), (32, 32, 128),
              (32, 3, 128)]
# The spine recipes' levels, [N, D, H, W] with their channels. The upstream
# configs/mri_spine_seg/*_512_512_12_15k.yml (batch 3) see a 512 x 512 x 12
# volume; their down convs are VALID with kernels (2, 2, 4), (2, 2, 2),
# (2, 2, 2), (2, 2, 2) and strides (2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2,
# 2), so W runs 12 -> 9 -> 8 -> 4 -> 2 (medicalseg_tpu/models/vnet.py). The
# synthetic flagship (configs/synthetic/vnetdeepsup_synspine_15k.yml) sees
# 12 x 512 x 512 with strides (1, 2, 2), (1, 2, 2), then (2, 2, 2). Heads of
# 20 classes.
SPINE_LEVELS = [((3, 512, 512, 12), 16), ((3, 256, 256, 9), 32),
                ((3, 128, 128, 8), 64), ((3, 64, 64, 4), 128),
                ((3, 32, 32, 2), 256),
                ((3, 12, 512, 512), 16), ((3, 12, 256, 256), 32),
                ((3, 12, 128, 128), 64), ((3, 6, 64, 64), 128),
                ((3, 3, 32, 32), 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# (a) the split
# ----------------------------------------------------------------------
def _bits(t):
    return t.contiguous().view(torch.int32)


def test_split_hi_has_13_zero_low_bits_and_reconstructs():
    a = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32) * np.float32(10.0) ** np.random.RandomState(1).randint(
            -20, 20, 4096).astype(np.float32))
    hi, lo = c5.split_tf32(a)
    assert not (_bits(hi) & 0x1fff).any() and not (_bits(lo) & 0x1fff).any()
    # hi is a to nearest TF32: within half a TF32 ulp (2^-11 relative)
    assert ((a - hi).abs() <= a.abs() * 2.0 ** -11).all()
    # hi + lo: a to 2^-22 relative
    rel = ((a.double() - hi.double() - lo.double()).abs() /
           a.double().abs())
    assert rel.max().item() <= 2.0 ** -22


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_ties_round_away_from_zero(sign):
    """Low bits exactly 0x1000 (half a TF32 ulp) round up in magnitude,
    for either sign, as cvt.rna.tf32.f32 does; just under half rounds
    down."""
    base = 1.0 + 2.0 ** -10  # a TF32 value, last mantissa bit set
    tie = torch.tensor([base], dtype=torch.float32) * sign
    tie = (_bits(tie) | 0x1000).view(torch.float32)
    hi, lo = c5.split_tf32(tie)
    assert hi.item() == sign * (1.0 + 2.0 ** -9)
    assert hi.item() + lo.item() == tie.item()
    under = (_bits(torch.tensor([sign * base], dtype=torch.float32)) |
             0x0fff).view(torch.float32)
    assert c5.split_tf32(under)[0].item() == sign * base


def _tf32_dot(a, b, split=True):
    """The kernels' product of two f32 operands: hi*hi + hi*lo + lo*hi
    (or, ``split=False``, one TF32 product)."""
    ah, al = c5.split_tf32(a)
    bh, bl = c5.split_tf32(b)
    if not split:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def test_three_products_keep_f32_accuracy_and_one_does_not():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(64, 512).astype(np.float32))
    b = torch.from_numpy(rng.randn(512, 64).astype(np.float32))
    ref = (a.double() @ b.double())
    scale = ref.abs().max().item()
    err3 = (_tf32_dot(a, b).double() - ref).abs().max().item() / scale
    err1 = (_tf32_dot(a, b, False).double() - ref).abs().max().item() / scale
    f32 = ((a @ b).double() - ref).abs().max().item() / scale
    assert err3 <= 4 * f32 + 1e-7
    assert err1 > 1e-4


# ----------------------------------------------------------------------
# (b) launch geometry
# ----------------------------------------------------------------------
def _check_fwd_geometry(n, d, h, w, ci, co):
    q = c5.conv5_tf32_geometry(n, d, h, w, ci, co)
    td, th, tw = q["td"], q["th"], q["tw"]
    assert td * th * tw == 256 and tw in (8, 16, 32) and td <= 4
    assert q["nf"] in (1, 2, 3, 4) and q["nt"] == 8 * q["nf"]
    assert q["co_tiles"] * q["nt"] >= co > (q["co_tiles"] - 1) * q["nt"]
    assert q["chunks"] * 8 >= ci > (q["chunks"] - 1) * 8
    assert q["stages"] == 5 * q["chunks"]
    # the staged box: room for the halo; 4 channels x 8 voxels of a
    # fragment load of (hi, lo) pairs on each bank once a half-warp
    # the raw box from 4 columns left of the tile (16-byte copies), its
    # plane 4 mod 8 (the split pass's 4-channel reads on distinct banks);
    # the split planes 48 bytes a voxel (an ldmatrix's 8 rows on distinct
    # banks)
    assert q["pitch"] == tw + 8
    assert q["plane"] >= (th + 4) * q["pitch"] and q["plane"] % 8 == 4
    assert q["voxels"] == td * (th + 4) * (tw + 4)
    assert q["x_stage"] == 4 * td * 8 * q["plane"] + 96 * q["voxels"]
    assert q["w_stage"] == 16 * 25 * q["nf"] * 32
    assert q["smem"] == q["x_stage"] + q["w_stage"] <= SMEM_MAX
    assert q["blocks_per_sm"] == (2 if 2 * q["smem"] <= SMEM_MAX else 1)
    gx, gy, gz = q["grid"]
    assert gx == -(-d // td) * -(-h // th) * -(-w // tw)
    assert gy == n * q["co_tiles"] and gz == q["splits"]
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535
    assert 1 <= q["splits"] <= min(q["stages"], 65535)
    ranges = c5.conv5_wg_split_ranges(q["stages"], q["splits"])
    assert all(b > a for a, b in ranges)
    return q


def _check_wgrad_geometry(n, d, h, w, ci, co):
    q = c5.conv5_wgrad_tf32_geometry(n, d, h, w, ci, co)
    th, tw, nf = q["th"], q["tw"], q["nf"]
    assert tw in (8, 16, 32) and 1 <= th <= 8
    assert nf == (1 if co <= 8 else 2 if co <= 16 else 4)
    # channel planes on 32 banks a fragment load (x from 4 columns left:
    # 16-byte copies); the raw tile and its hi and lo halves
    assert q["xplane"] >= (th + 4) * (tw + 8) and q["xplane"] % 8 == 4
    assert q["gplane"] >= th * tw and q["gplane"] % 8 == 4
    assert q["smem"] == 12 * (16 * q["xplane"] + 8 * nf * q["gplane"])
    assert q["smem"] <= SMEM_MAX
    assert q["blocks_per_sm"] == (2 if 2 * q["smem"] <= SMEM_MAX else 1)
    assert q["tiles"] == n * d * -(-h // th) * -(-w // tw)
    assert q["chan_blocks"] == 5 * -(-ci // 16) * -(-co // (8 * nf))
    # each split a contiguous range of at least one tile
    per = -(-q["tiles"] // q["splits"])
    assert -(-q["tiles"] // per) == q["splits"] <= 65535
    assert q["grid"] == (q["chan_blocks"], q["splits"])
    assert q["threads"] == 160 * (2 if nf > 1 else 1)
    return q


@pytest.mark.parametrize("ci,co,edge", CUBE_CONVS)
def test_geometry_cube_convs(ci, co, edge):
    """Every f32 head conv of the 2 x 128^3 pass, its input gradient (Ci
    and Co swapped) and its weight gradient; the deep 8^3 level splits K
    to fill the card."""
    q = _check_fwd_geometry(2, edge, edge, edge, ci, co)
    _check_fwd_geometry(2, edge, edge, edge, co, ci)
    _check_wgrad_geometry(2, edge, edge, edge, ci, co)
    if edge == 8:
        assert q["splits"] > 1 and q["td"] == 4
    if co == 3:  # the narrow head: one n8 tile, 5 of its 8 columns padding
        assert q["nf"] == 1


@pytest.mark.parametrize("shape,c", SPINE_LEVELS,
                         ids=["x".join(map(str, s)) for s, _ in SPINE_LEVELS])
def test_geometry_spine_levels(shape, c):
    """The square convs of each spine level, the stem's neighbour 16 -> 16
    and the 32 -> 20 head where the level is the top one."""
    n, d, h, w = shape
    _check_fwd_geometry(n, d, h, w, c, c)
    _check_wgrad_geometry(n, d, h, w, c, c)
    if c == 16:
        q = _check_fwd_geometry(n, d, h, w, 32, 20)
        assert q["nf"] == 3  # 20 -> 24 columns: 1/6 padding
        _check_fwd_geometry(n, d, h, w, 20, 32)
        _check_wgrad_geometry(n, d, h, w, 32, 20)


@pytest.mark.parametrize("n,d,h,w,c", [(1, 128, 68, 128, 32),
                                       (3, 12, 260, 512, 32),
                                       (1, 8, 8, 8, 256),
                                       (1, 128, 9, 128, 16)])
def test_geometry_halo_h_blocks(n, d, h, w, c):
    """A space rank's block with its 2 + 2 halo rows (H / S + 4: the cube
    and the flagship over S = 2, the deep level's 4 + 4, a long window)."""
    _check_fwd_geometry(n, d, h, w, c, c)
    _check_wgrad_geometry(n, d, h, w, c, c)


@settings(max_examples=80, deadline=None)
@given(n=st.integers(1, 3), d=st.integers(1, 40), h=st.integers(1, 600),
       w=st.integers(1, 600), ci=st.integers(1, 256), co=st.integers(1, 256))
def test_geometry_odd_shapes(n, d, h, w, ci, co):
    _check_fwd_geometry(n, d, h, w, ci, co)
    _check_wgrad_geometry(n, d, h, w, ci, co)


# ----------------------------------------------------------------------
# (c) the packed weights and their cache
# ----------------------------------------------------------------------
def _unpack(packed, ci, co):
    """The kernel's B fragments back to (hi, lo), each [5, 25, Ci, Co]:
    lane (g, t) of n8 tile f holds W[tap, t (+ 4), 8 f + g]."""
    tiles, _, chunks, _, nf = packed.shape[:5]
    # [tile, kd, chunk, tap, f, g, t, hl, khalf] ->
    # [hl, kd, tap, chunk, khalf, t, tile, f, g]
    w = packed.permute(7, 1, 3, 2, 8, 6, 0, 4, 5).reshape(
        2, 5, 25, chunks * 8, tiles * nf * 8)
    return w[0, :, :, :ci, :co], w[1, :, :, :ci, :co]


@pytest.mark.parametrize("ci,co,nf", [(8, 3, 1), (20, 40, 4), (32, 20, 3),
                                      (3, 16, 2)])
@pytest.mark.parametrize("dgrad", [False, True])
def test_packed_weights_round_trip(ci, co, nf, dgrad):
    rng = np.random.RandomState(ci + co)
    w = torch.from_numpy(rng.randn(5, 5, 5, ci, co).astype(np.float32))
    packed = c5._pack_weights_tf32(w, nf, dgrad)
    src = w.flip(0, 1, 2).transpose(3, 4) if dgrad else w
    ci_, co_ = src.shape[3:]
    assert packed.shape == (-(-co_ // (8 * nf)), 5, -(-ci_ // 8), 25, nf, 8,
                            4, 2, 2)
    hi, lo = _unpack(packed, ci_, co_)
    want_hi, want_lo = c5.split_tf32(src.reshape(5, 25, ci_, co_))
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert ((hi + lo) - src.reshape(5, 25, ci_, co_)).abs().max() <= \
        2.0 ** -22 * src.abs().max()
    # the padding is zero
    full = packed.permute(7, 1, 3, 2, 8, 6, 0, 4, 5).reshape(
        2, 5, 25, packed.shape[2] * 8, -1)
    assert full[..., ci_:, :].abs().sum() == 0
    assert full[..., co_:].abs().sum() == 0


def _layer_weight(ci, co, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.nn.Parameter(torch.randn((co, ci, 5, 5, 5), generator=gen))


def _view(param):  # what the layer hands the wrapper: [5, 5, 5, Ci, Co]
    return param.permute(2, 3, 4, 1, 0)


def test_packed_weight_cached_per_form():
    p = _layer_weight(16, 32, 0)
    first = c5._packed_weight(_view(p), ("tf32", 4))
    assert c5._packed_weight(_view(p), ("tf32", 4)) is first
    assert torch.equal(first, c5._pack_weights_tf32(_view(p).detach(), 4))
    back = c5._packed_weight(_view(p), ("tf32", 4), True)
    assert back is not first
    assert torch.equal(back, c5._pack_weights_tf32(_view(p).detach(), 4,
                                                   True))
    # the bf16 warpgroup form of the same parameter is its own entry
    assert c5._packed_weight(_view(p), 32) is not first


@pytest.mark.parametrize("update", ["add_", "sgd", "load_state_dict"])
def test_packed_weight_rebuilt_after_inplace_update(update):
    p = _layer_weight(8, 8, 1)
    first = c5._packed_weight(_view(p), ("tf32", 1))
    if update == "add_":
        with torch.no_grad():
            p.add_(1.0)
    elif update == "sgd":
        p.grad = torch.ones_like(p)
        torch.optim.SGD([p], lr=0.5).step()
    else:
        m = torch.nn.Module()
        m.w = p
        m.load_state_dict({"w": torch.zeros_like(p)})
    again = c5._packed_weight(_view(p), ("tf32", 1))
    assert again is not first
    assert torch.equal(again, c5._pack_weights_tf32(_view(p).detach(), 1))


# ----------------------------------------------------------------------
# (d) the forms gate
# ----------------------------------------------------------------------
def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,kind,ci,co,fwd,wgrad", [
    (torch.float32, "head", 32, 32, "head_tf32", "tf32"),
    (torch.float32, "head", 32, 3, "head_tf32", "tf32"),
    (torch.float32, "head", 256, 256, "head_tf32", "tf32"),
    (torch.float32, "stem", 1, 16, "stem_tf32", "stem_tf32"),
    (torch.bfloat16, "head", 32, 32, "head", "tma"),
    (torch.bfloat16, "stem", 1, 16, "stem_tc", "stem_tc")])
def test_gate_forms(dtype, kind, ci, co, fwd, wgrad):
    x, g = _meta((2, 8, ci, 8, 16), dtype), _meta((2, 8, co, 8, 16), dtype)
    assert c5.conv5_form(x, co, kind) == fwd
    assert c5.conv5_wgrad_form(x, g, kind) == wgrad


def test_gate_takes_ragged_f32_views():
    """The split-TF32 kernels stage x and g by 4-byte copies with zero fill,
    so an f32 conv takes them at any W-contiguous view: W = 13 rows, a base
    4 bytes into an allocation, a channel slice; the stem too, on its own
    split-TF32 kernels."""
    x = torch.zeros((1, 3, 8, 5, 13))
    flat = torch.zeros(x.numel() + 1)
    wide = torch.zeros((1, 3, 12, 5, 13))
    for xv in (x, flat[1:].view(x.shape), wide[:, :, 2:10]):
        assert c5.conv5_form(xv, 3, "head") == "head_tf32"
        assert c5.conv5_wgrad_form(xv, wide[:, :, :3], "head") == "tf32"
    assert c5.conv5_wgrad_form(torch.zeros((1, 3, 1, 5, 13)), x,
                               "stem") == "stem_tf32"


def test_f32_vnet_step_hands_every_head_conv_to_the_new_kernels(monkeypatch):
    """An f32 V-Net forward and backward on the CPU, the wrappers recorded:
    15 head convs 'head_tf32' and the stem 'stem_tf32'; 15 input gradients
    (the stem's input is the image); 15 weight gradients 'tf32' and the
    stem's 'stem_tf32'."""
    seen = {"fwd": [], "wgrad": []}
    fwd, wgrad = c5._conv5_forward, c5.conv5_wgrad_kl

    def record(xk, w, b, kind):
        seen["fwd"].append(c5.conv5_form(xk, w.shape[4], kind))
        return fwd(xk, w, b, kind)

    def record_w(xk, gk, kind="head"):
        seen["wgrad"].append(c5.conv5_wgrad_form(xk, gk, kind))
        return wgrad(xk, gk, kind)

    monkeypatch.setattr(c5, "_conv5_forward", record)
    monkeypatch.setattr(c5, "conv5_wgrad_kl", record_w)
    model = VNet(num_classes=3, generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.RandomState(4).rand(
        1, 16, 16, 16, 1).astype(np.float32))
    model(x)[0].sum().backward()
    assert sorted(seen["fwd"]) == ["head_tf32"] * 15 + ["stem_tf32"]
    assert sorted(seen["wgrad"]) == ["stem_tf32"] + ["tf32"] * 15


# ----------------------------------------------------------------------
# (e) the kernels' order of summation, emulated
# ----------------------------------------------------------------------
def _emulate_fwd(xk, w, b, ep, dgrad=False, split=True):
    """``conv5_tf32_kernel`` in plain PyTorch: the packed pre-split
    weights, the input split per value, per split of the (depth tap,
    8-channel chunk) stages the 25 taps' hi*lo, lo*hi and hi*hi products
    summed in f32, the partials added in split order, then bias and
    epilogue. ``split=False``: one TF32 product a term."""
    n, d, ci, h, ww = xk.shape
    co = w.shape[3] if dgrad else w.shape[4]
    q = c5.conv5_tf32_geometry(n, d, h, ww, ci, co)
    bh, bl = _unpack(c5._pack_weights_tf32(w, q["nf"], dgrad),
                     q["chunks"] * 8, q["co_tiles"] * q["nt"])
    xp = F.pad(xk.float(), (2, 2, 2, 2, 0, q["chunks"] * 8 - ci, 2, 2))
    xh, xl = c5.split_tf32(xp)
    parts = []
    for first, last in c5.conv5_wg_split_ranges(q["stages"], q["splits"]):
        acc = torch.zeros((n, d, h, ww, bh.shape[-1]))
        for stage in range(first, last):
            kd, ch = divmod(stage, q["chunks"])
            cs = slice(ch * 8, ch * 8 + 8)
            for tap in range(25):
                kh, kw = divmod(tap, 5)
                sl = (slice(None), slice(kd, kd + d), cs, slice(kh, kh + h),
                      slice(kw, kw + ww))
                ah = xh[sl].permute(0, 1, 3, 4, 2)
                if not split:
                    acc += ah @ bh[kd, tap, cs]
                    continue
                al = xl[sl].permute(0, 1, 3, 4, 2)
                acc += al @ bh[kd, tap, cs]
                acc += ah @ bl[kd, tap, cs]
                acc += ah @ bh[kd, tap, cs]
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    out = out[..., :co].permute(0, 1, 4, 2, 3)
    if b is not None:
        out = out + b.reshape(1, 1, -1, 1, 1)
    if ep is not None:
        inv, shift, alpha = (v.reshape(1, 1, -1, 1, 1) for v in ep)
        out = out * inv + shift
        out = torch.where(out >= 0, out, out * alpha)
    return out.contiguous()


def _emulate_wgrad(xk, gk, split=True):
    """``wgrad_tf32_kernel`` in plain PyTorch: both operands split per
    value, per tap the voxels of each split's tiles contracted as lo*hi,
    hi*lo and hi*hi in f32, the partials added in split order."""
    n, d, ci, h, ww = xk.shape
    co = gk.shape[2]
    q = c5.conv5_wgrad_tf32_geometry(n, d, h, ww, ci, co)
    th, tw = q["th"], q["tw"]
    hp, wp = -(-h // th) * th, -(-ww // tw) * tw
    xp = F.pad(xk.float(), (2, 2 + wp - ww, 2, 2 + hp - h, 0, 0, 2, 2))
    gp = F.pad(gk.float(), (0, wp - ww, 0, hp - h))

    def tiles(t):  # [.., C, hp, wp] -> [C, tiles in kernel order, th * tw]
        c = t.shape[2]
        t = t.reshape(n, d, c, hp // th, th, wp // tw, tw)
        return t.permute(2, 0, 1, 3, 5, 4, 6).reshape(c, q["tiles"],
                                                      th * tw)

    gh, gl = c5.split_tf32(tiles(gp))
    per = -(-q["tiles"] // q["splits"])
    dw = torch.zeros((5, 5, 5, ci, co))
    for kd in range(5):
        for kh in range(5):
            for kw in range(5):
                xh, xl = c5.split_tf32(tiles(
                    xp[:, kd:kd + d, :, kh:kh + hp, kw:kw + wp]))
                out = None
                for z in range(q["splits"]):
                    s = slice(z * per, (z + 1) * per)
                    a_h = xh[:, s].reshape(ci, -1)
                    b_h = gh[:, s].reshape(co, -1).t()
                    if split:
                        a_l = xl[:, s].reshape(ci, -1)
                        b_l = gl[:, s].reshape(co, -1).t()
                        part = a_l @ b_h + a_h @ b_l + a_h @ b_h
                    else:
                        part = a_h @ b_h
                    out = part if out is None else out + part
                dw[kd, kh, kw] = out
    return dw


def _data(n, d, h, w, ci, co, seed):
    rng = np.random.RandomState(seed)
    xk = torch.from_numpy(rng.randn(n, d, ci, h, w).astype(np.float32))
    k = torch.from_numpy((rng.randn(5, 5, 5, ci, co) /
                          np.sqrt(125 * ci)).astype(np.float32))
    b = torch.from_numpy(rng.randn(co).astype(np.float32))
    ep = tuple(torch.from_numpy(v.astype(np.float32)) for v in (
        0.5 + rng.rand(co), rng.randn(co), rng.rand(co)))
    g = torch.from_numpy(rng.randn(n, d, co, h, w).astype(np.float32))
    return xk, k, b, ep, g


def _scaled_err(got, ref):
    return ((got - ref).abs() / (ref.abs().max() + ref.abs())).max().item()


# small shapes: a split K (the deep level's form), Co 3, ragged H and W,
# Ci not a multiple of 8
SHAPES = [(1, 4, 4, 32, 8, 3), (2, 3, 5, 9, 12, 20), (1, 2, 8, 8, 16, 8)]


@pytest.mark.parametrize("n,d,h,w,ci,co", SHAPES)
@pytest.mark.parametrize("fused", [False, True])
def test_emulated_forward_equals_plain(n, d, h, w, ci, co, fused):
    xk, k, b, ep, _ = _data(n, d, h, w, ci, co, seed=ci + co)
    ep = ep if fused else None
    got = _emulate_fwd(xk, k, b, ep)
    torch.testing.assert_close(got, c5.conv5_kl_plain(xk, k, b, ep),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,h,w,ci,co", SHAPES)
def test_emulated_dgrad_equals_plain(n, d, h, w, ci, co):
    _, k, _, _, g = _data(n, d, h, w, ci, co, seed=3 * ci + co)
    got = _emulate_fwd(g, k, None, None, dgrad=True)
    torch.testing.assert_close(got, c5.conv5_dgrad_kl_plain(g, k),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,h,w,ci,co", SHAPES)
def test_emulated_wgrad_equals_plain(n, d, h, w, ci, co):
    xk, _, _, _, g = _data(n, d, h, w, ci, co, seed=5 * ci + co)
    q = c5.conv5_wgrad_tf32_geometry(n, d, h, w, ci, co)
    got = _emulate_wgrad(xk, g)
    assert q["splits"] > 1 or q["tiles"] == 1
    assert _scaled_err(got, c5.conv5_wgrad_kl_plain(xk, g)) <= 1e-5


def test_split_stages_at_the_deep_level():
    """At the cube's deepest level (8^3, 256 channels) the forward splits
    its stages; the emulated split sums equal the plain version there at
    a narrower width."""
    q = c5.conv5_tf32_geometry(2, 8, 8, 8, 256, 256)
    assert q["splits"] > 1
    xk, k, b, ep, _ = _data(1, 8, 8, 8, 16, 8, seed=9)
    got = _emulate_fwd(xk, k, b, ep)
    torch.testing.assert_close(got, c5.conv5_kl_plain(xk, k, b, ep),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ci,co", [(8, 3), (16, 16)])
def test_emulated_kernels_match_pallas_interpret(ci, co):
    """Against the JAX package's Pallas kernels in f32 (interpret mode):
    the head forward, its input gradient through the Pallas custom VJP,
    and the narrow-head / mid weight-gradient kernels."""
    xk, k, b, _, g = _data(1, 4, 8, 128, ci, co, seed=11 * ci + co)
    assert pc.head_eligible((1, 4, 8, 128, ci), ci, co)
    jx, jk, jb, jg = (jnp.asarray(t.numpy()) for t in (xk, k, b, g))
    ref = np.asarray(pc.conv5_kl(jx, jk, jb, "head", True))
    np.testing.assert_allclose(_emulate_fwd(xk, k, b, None).numpy(), ref,
                               atol=1e-4, rtol=1e-4)
    dx = jax.grad(lambda x_: jnp.vdot(pc.conv5_kl(x_, jk, jb, "head", True),
                                      jg))(jx)
    np.testing.assert_allclose(
        _emulate_fwd(g, k, None, None, dgrad=True).numpy(), np.asarray(dx),
        atol=1e-4, rtol=1e-4)
    dw = (pc._conv5_wgrad_kl(jx, jg, "head", interpret=True) if co <= 8 else
          pc._conv5_wgrad_mid_kl(jx, jg, interpret=True))
    dw = np.asarray(dw)
    np.testing.assert_allclose(_emulate_wgrad(xk, g).numpy(), dw,
                               atol=1e-4 * np.abs(dw).max(), rtol=1e-4)


def test_one_tf32_product_misses_the_f32_tolerance():
    """The same emulations with one TF32 product a term (hi*hi) miss
    atol = rtol = 1e-4 against the plain versions; the split keeps 1e-5."""
    xk, k, b, _, g = _data(1, 4, 8, 16, 16, 16, seed=21)
    ref = c5.conv5_kl_plain(xk, k, b)
    one = _emulate_fwd(xk, k, b, None, split=False)
    assert not torch.allclose(one, ref, atol=1e-4, rtol=1e-4)
    assert torch.allclose(_emulate_fwd(xk, k, b, None), ref, atol=1e-5,
                          rtol=1e-5)
    ref_w = c5.conv5_wgrad_kl_plain(xk, g)
    assert _scaled_err(_emulate_wgrad(xk, g, split=False), ref_w) > 1e-4
    assert _scaled_err(_emulate_wgrad(xk, g), ref_w) <= 1e-5
