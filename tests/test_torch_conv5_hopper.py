"""What the CPU can hold of the warpgroup conv5 kernel and the 16-byte pin
(medicalseg_torch/ops/conv5.py, csrc/conv5_wg.cu, csrc/pin.cu): the launch
geometry, the packed weights and their cache, the kernel's order of
summation emulated in plain PyTorch over the packed form, and the pin's
plan. The kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them to the plain versions there).

Tolerances: the emulation against the plain version is float32 on
bf16-representable operands, the same products summed in another order:
atol = rtol = 1e-5. Against the JAX package's Pallas kernel (interpret mode
on the CPU, as tests/test_pallas_conv5.py runs it) atol 1e-4, as in
tests/test_torch_conv5.py.
"""
import gc

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from medicalseg_tpu.ops import pallas_conv5 as pc
from medicalseg_torch.ops import conv5 as c5

SMEM_MAX = 227 * 1024
SMS = 132
# (Ci, Co, edge) of the bf16 head convs of one V-Net forward at 128^3
HEAD_CONVS = [(32, 32, 64), (64, 64, 32), (128, 128, 16), (256, 256, 8),
              (256, 256, 16), (128, 128, 32), (64, 64, 64), (32, 32, 128),
              (32, 3, 128)]
# the views the forward pins: [N, C, D, H, W] seen as [N, D, C, H, W]
PINS = [(32, 64), (64, 32), (128, 16), (256, 8), (128, 16), (64, 32),
        (32, 64), (16, 128)]


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
    q = c5.conv5_wg_geometry(n, d, h, w, ci, co)
    nt, mt, td, th, tw = q["nt"], q["mt"], q["td"], q["th"], q["tw"]
    # one wgmma's N, and at most 128 accumulators a thread
    assert nt in (8, 32, 64, 128) and mt * nt // 2 <= 128
    # the tile is made of 8 x 8 patches, one m64 tile each
    assert th >= 8 and tw >= 8 and td >= 1
    assert all(t & (t - 1) == 0 for t in (td, th, tw))  # shifts, not divisions
    assert td * th * tw <= 128 * mt
    # tiles cover every voxel and channel
    tiles_d, tiles_h, tiles_w = -(-d // td), -(-h // th), -(-w // tw)
    assert tiles_d * td >= d and tiles_h * th >= h and tiles_w * tw >= w
    assert q["co_tiles"] * nt >= co > (q["co_tiles"] - 1) * nt
    assert q["chunks"] * 16 >= ci > (q["chunks"] - 1) * 16
    assert q["stages"] == 5 * q["chunks"]
    # the halo row pitch: room for the halo, 6 mod 8 voxels
    assert q["sw"] >= tw + 4 and q["sw"] % 8 == 6
    # shared memory: the card's limit, halved where two blocks share an SM
    rows = td * (th + 4)
    plane = rows * q["sw"] * 16
    plane += (16 - plane) % 128
    assert plane % 128 == 16
    assert q["x_stage"] == -(-2 * plane // 128) * 128
    assert q["r_stage"] == rows * 16 * ((tw + 1) // 8 + 2) * 16
    assert q["smem"] == (256 + q["ws"] * 5 * nt * 32 + 2 * q["x_stage"] +
                         2 * q["r_stage"])
    assert q["smem"] <= SMEM_MAX // q["blocks_per_sm"]
    # the grid: CUDA's limits, and the work it stands for
    gx, gy, gz = q["grid"]
    assert gx == tiles_d * tiles_h * tiles_w and gy == n * q["co_tiles"]
    assert gz == q["splits"]
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    # split K: each (depth tap, chunk) stage in exactly one split, no split
    # empty; the count that makes the launch shortest by the documented
    # cost (waves of blocks times stages a block, plus the second pass)
    ranges = c5.conv5_wg_split_ranges(q["stages"], q["splits"])
    assert len(ranges) == q["splits"]
    flat = [s for a, b in ranges for s in range(a, b)]
    assert flat == list(range(q["stages"]))
    assert all(b > a for a, b in ranges)
    resident = SMS * q["blocks_per_sm"]
    assert q["blocks_per_sm"] == (2 if nt <= 32 else 1)

    def cost(s):
        waves = -(-gx * gy * s // resident)
        return waves * (-(-q["stages"] // s) + 2) + (s > 1) * (1 + 0.25 * s)

    assert all(cost(q["splits"]) <= cost(s)
               for s in range(1, q["stages"] + 1))
    return q


@pytest.mark.parametrize("ci,co,edge", HEAD_CONVS)
@pytest.mark.parametrize("dgrad", [False, True])
def test_geometry_vnet_convs(ci, co, edge, dgrad):
    """Every bf16 head conv of the 128^3 batch-2 forward, and its input
    gradient (the same kernel with Ci and Co swapped)."""
    q = _check_geometry(2, edge, edge, edge, *((co, ci) if dgrad else
                                               (ci, co)))
    # the deep levels are the ones that split K, and there the split fills
    # (nearly) one wave of the card: about one block per SM
    assert (q["splits"] > 1) == (edge <= 16)
    if q["splits"] > 1:
        blocks = q["grid"][0] * q["grid"][1] * q["splits"]
        assert 0.9 * SMS <= blocks <= SMS
    # a full tile at every level but 8^3, where the deeper weight ring
    # leaves room for two of the four depth slices
    assert q["td"] * q["th"] * q["tw"] * (2 if edge == 8 else 1) \
        == 128 * q["mt"]


@pytest.mark.parametrize("ci,co", [(16, 16), (32, 32), (64, 64), (128, 128),
                                   (256, 256), (32, 3), (3, 32)])
def test_geometry_spine_shapes(ci, co):
    """The spine recipe's thin volumes: D = 12, 512 x 512 planes, and the
    levels below them."""
    for level in range(3):
        _check_geometry(1, max(1, 12 >> level), 512 >> level, 512 >> level,
                        ci, co)


@settings(max_examples=120, deadline=None)
@given(n=st.integers(1, 3), d=st.integers(1, 40), h=st.integers(1, 70),
       w=st.integers(1, 70), ci=st.integers(1, 256), co=st.integers(1, 256))
def test_geometry_odd_shapes(n, d, h, w, ci, co):
    _check_geometry(n, d, h, w, ci, co)


@pytest.mark.parametrize("d,td", [(1, 1), (3, 2), (8, 4), (12, 1), (5, 4)])
def test_skipped_depth_taps_hold_no_input(d, td):
    """The block skips the depth taps [0, kd_lo) and (kd_hi, 4] (the
    kernel's formulas): none of their input slices lies in the volume, and
    every tap it keeps has at least one that does."""
    for d0 in range(0, d, td):
        kd_lo = max(0, 2 - (d0 + td - 1))
        kd_hi = min(4, d - 1 + 2 - d0)
        for kd in range(5):
            # input slices of the tile's output slices that exist
            inside = [0 <= od + kd - 2 < d
                      for od in range(d0, min(d0 + td, d))]
            if kd < kd_lo or kd > kd_hi:
                assert not any(inside)
            # a kept tap may still be all padding for a ragged last tile;
            # the producers fill zeros then
        assert kd_lo <= 2 <= kd_hi  # the centre tap always runs


# ----------------------------------------------------------------------
# (b) packed weights and the kernel's order of summation
# ----------------------------------------------------------------------
def _unpack(packed, ci, co):
    """Packed [tiles, kd, chunks, kh, kw, nt/8, 2, 8, 8] -> [5, 5, 5, Ci',
    Co'] (padded sizes), the inverse of the layout."""
    tiles, _, chunks, _, _, ng = packed.shape[:6]
    # [tile, kd, chunk, kh, kw, ng, half, n8, k8] -> [kd, kh, kw, chunk,
    # half, k8, tile, ng, n8]
    full = packed.permute(1, 3, 4, 2, 6, 8, 0, 5, 7).reshape(
        5, 5, 5, chunks * 16, tiles * ng * 8)
    return full


@pytest.mark.parametrize("ci,co,nt", [(32, 32, 32), (16, 64, 64), (3, 32, 32),
                                      (32, 3, 8), (20, 40, 64), (5, 7, 8),
                                      (48, 130, 128), (1, 1, 8)])
@pytest.mark.parametrize("dgrad", [False, True])
def test_pack_roundtrip(ci, co, nt, dgrad):
    rng = np.random.RandomState(ci * 7 + co)
    w = torch.from_numpy(rng.randn(5, 5, 5, ci, co).astype(np.float32))
    if dgrad:  # the conv the kernel runs has Ci and Co swapped
        nt = c5.conv5_wg_geometry(1, 8, 8, 8, co, ci)["nt"]
    packed = c5._pack_weights_wg(w, nt, dgrad)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    kci, kco = (co, ci) if dgrad else (ci, co)
    assert tuple(packed.shape) == (-(-kco // nt), 5, -(-kci // 16), 5, 5,
                                   nt // 8, 2, 8, 8)
    full = _unpack(packed, kci, kco)
    want = (w.transpose(3, 4) if dgrad else w).to(torch.bfloat16)
    # bit for bit, and zeros in the padding
    assert torch.equal(full[..., :kci, :kco].view(torch.int16),
                       want.contiguous().view(torch.int16))
    assert not full[..., kci:, :].any() and not full[..., :, kco:].any()


def _emulate_wg(xk, w, b, ep, dgrad, q):
    """The warpgroup kernel's arithmetic in plain PyTorch over the packed
    weights: per split the (depth tap, chunk) stages of its range, per
    stage the 25 taps as [voxels, 16] x [16, Co] products on the packed
    tap (walked backwards for the input gradient), f32 partials summed in
    split order, then bias, epilogue. Returns f32 before the one cast."""
    n, d, ci, h, ww = xk.shape
    packed = c5._pack_weights_wg(w, q["nt"], dgrad).float()
    tiles, chunks = packed.shape[0], packed.shape[2]
    co = w.shape[3] if dgrad else w.shape[4]
    # per tap [Co', 16]: [tile, ng, half, n8, k8] -> [tile, ng, n8, half, k8]
    taps = packed.permute(1, 2, 3, 4, 0, 5, 7, 6, 8).reshape(
        5, chunks, 5, 5, tiles * q["nt"], 16)
    xp = F.pad(xk.float(), (2, 2, 2, 2, 0, chunks * 16 - ci, 2, 2))
    parts = []
    for first, last in c5.conv5_wg_split_ranges(q["stages"], q["splits"]):
        acc = torch.zeros((n, d, h, ww, tiles * q["nt"]))
        for stage in range(first, last):
            kd, ch = divmod(stage, chunks)
            for kh in range(5):
                for kw in range(5):
                    tap = xp[:, kd:kd + d, ch * 16:ch * 16 + 16,
                             kh:kh + h, kw:kw + ww].permute(0, 1, 3, 4, 2)
                    wt = (taps[4 - kd, ch, 4 - kh, 4 - kw] if dgrad else
                          taps[kd, ch, kh, kw])
                    acc += tap @ wt.t()
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


def _bf16_values(a):
    """float32 array whose values are bf16-representable."""
    return torch.from_numpy(a).to(torch.bfloat16).float()


def _conv_data(n, d, h, w, ci, co, seed):
    rng = np.random.RandomState(seed)
    xk = _bf16_values(rng.randn(n, d, ci, h, w).astype(np.float32))
    k = _bf16_values((rng.randn(5, 5, 5, ci, co) /
                      np.sqrt(125 * ci)).astype(np.float32))
    b = torch.from_numpy(rng.randn(co).astype(np.float32))
    ep = tuple(torch.from_numpy(v.astype(np.float32)) for v in (
        0.5 + rng.rand(co), rng.randn(co), rng.rand(co)))
    g = _bf16_values(rng.randn(n, d, co, h, w).astype(np.float32))
    return xk, k, b, ep, g


@pytest.mark.parametrize("n,d,h,w,ci,co", [(1, 4, 4, 32, 8, 3),
                                           (2, 3, 5, 9, 20, 40),
                                           (1, 2, 8, 8, 32, 16),
                                           (1, 1, 7, 5, 3, 5)])
@pytest.mark.parametrize("fused", [False, True])
def test_emulated_forward_equals_plain(n, d, h, w, ci, co, fused):
    xk, k, b, ep, _ = _conv_data(n, d, h, w, ci, co, seed=ci + co)
    q = c5.conv5_wg_geometry(n, d, h, w, ci, co)
    assert q["splits"] > 1  # small grids: the split path is what runs
    got = _emulate_wg(xk, k, b, ep if fused else None, False, q)
    ref = c5.conv5_kl_plain(xk, k, b, ep if fused else None)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,h,w,ci,co", [(1, 4, 4, 32, 8, 3),
                                           (2, 3, 5, 9, 20, 40),
                                           (1, 2, 8, 8, 32, 16)])
def test_emulated_dgrad_equals_plain(n, d, h, w, ci, co):
    _, k, _, _, g = _conv_data(n, d, h, w, ci, co, seed=3 * ci + co)
    q = c5.conv5_wg_geometry(n, d, h, w, co, ci)  # the conv that runs
    got = _emulate_wg(g, k, None, None, True, q)
    ref = c5.conv5_dgrad_kl_plain(g, k)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    # and it is the gradient: autograd of the plain forward agrees
    x = torch.zeros((n, d, ci, h, w), requires_grad=True)
    c5.conv5_kl_plain(x, k, torch.zeros(co)).backward(g)
    torch.testing.assert_close(got, x.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ci,co", [(8, 3), (32, 16)])
def test_emulated_forward_equals_pallas_interpret(ci, co):
    xk, k, b, _, _ = _conv_data(1, 4, 4, 32, ci, co, seed=11 * ci + co)
    x_ndhwc_shape = (1, 4, 4, 32, ci)
    assert pc.head_eligible(x_ndhwc_shape, ci, co)  # the Pallas kernel runs
    ref = np.asarray(pc.conv5_kl(jnp.asarray(xk.numpy()),
                                 jnp.asarray(k.numpy()),
                                 jnp.asarray(b.numpy()), "head", True))
    q = c5.conv5_wg_geometry(1, 4, 4, 32, ci, co)
    got = _emulate_wg(xk, k, b, None, False, q).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_split_order_is_fixed():
    """Two emulations give the same bits, and so do partials summed in
    split order by the wrapper's ranges (no dependence on timing)."""
    xk, k, b, _, _ = _conv_data(1, 3, 6, 10, 24, 9, seed=5)
    q = c5.conv5_wg_geometry(1, 3, 6, 10, 24, 9)
    a = _emulate_wg(xk, k, b, None, False, q)
    assert torch.equal(a, _emulate_wg(xk, k, b, None, False, q))


# ----------------------------------------------------------------------
# (c) the packed-weight cache
# ----------------------------------------------------------------------
def _layer_weight(ci, co, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.nn.Parameter(torch.randn((co, ci, 5, 5, 5), generator=gen))


def _view(param):  # what the layer hands the wrapper: [5, 5, 5, Ci, Co]
    return param.permute(2, 3, 4, 1, 0)


def test_packed_weight_reused_while_unchanged():
    p = _layer_weight(16, 32, 0)
    first = c5._packed_weight(_view(p), 32)
    assert c5._packed_weight(_view(p), 32) is first  # a new view each call
    assert torch.equal(first, c5._pack_weights_wg(_view(p).detach(), 32))
    # the input gradient's form is its own entry of the same parameter
    back = c5._packed_weight(_view(p), 32, True)
    assert back is not first and c5._packed_weight(_view(p), 32, True) is back
    assert c5._packed_weight(_view(p), 32) is first


@pytest.mark.parametrize("update", ["add_", "sgd", "load_state_dict"])
def test_packed_weight_rebuilt_after_inplace_update(update):
    p = _layer_weight(16, 32, 1)
    first = c5._packed_weight(_view(p), 32)
    if update == "add_":
        with torch.no_grad():
            p.add_(1.0)
    elif update == "sgd":
        opt = torch.optim.SGD([p], lr=0.1)
        p.grad = torch.ones_like(p)
        opt.step()
    else:
        holder = torch.nn.ParameterDict({"w": p})
        holder.load_state_dict({"w": torch.zeros_like(p) + 3.0})
    second = c5._packed_weight(_view(p), 32)
    assert second is not first
    assert torch.equal(second, c5._pack_weights_wg(_view(p).detach(), 32))
    assert not torch.equal(second, first)
    assert c5._packed_weight(_view(p), 32) is second


def test_packed_weight_not_shared_between_parameters():
    p, r = _layer_weight(16, 32, 2), _layer_weight(16, 32, 3)
    a, b = c5._packed_weight(_view(p), 32), c5._packed_weight(_view(r), 32)
    assert a is not b and not torch.equal(a, b)
    assert torch.equal(b, c5._pack_weights_wg(_view(r).detach(), 32))
    assert c5._packed_weight(_view(p), 32) is a


def test_packed_weight_leaves_with_its_parameter():
    p = _layer_weight(8, 8, 4)
    key = id(p)
    c5._packed_weight(_view(p), 8)
    assert key in c5._PACKED
    del p
    gc.collect()
    assert key not in c5._PACKED


def test_packed_weight_of_inference_tensor_is_not_kept():
    before = len(c5._PACKED)
    with torch.inference_mode():
        w = torch.randn(5, 5, 5, 8, 8)
        a = c5._packed_weight(w, 8)
        assert c5._packed_weight(w, 8) is not a
    assert len(c5._PACKED) == before


# ----------------------------------------------------------------------
# (d) the pin's plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("c,e", PINS)
def test_pin_plan_model_views_take_16_byte_path(c, e):
    src = torch.empty((2, c, e, e, e), dtype=torch.bfloat16)
    view = src.transpose(1, 2)  # [N, D, C, H, W]
    plan = c5.pin_plan(tuple(view.shape), view.stride(), 2, 0)
    assert plan["path"] == "vec16"
    assert plan["run"] == e * e  # the (H, W) plane is one contiguous run
    assert plan["outer_shape"] == [2, e, c]
    assert plan["outer_stride"] == [c * e ** 3, e * e, e ** 3]


def test_pin_plan_element_path_cases():
    src = torch.empty((2, 16, 8, 8, 8), dtype=torch.bfloat16)
    view = src.transpose(1, 2)
    shape, stride = tuple(view.shape), view.stride()
    # a base that is not 16-byte aligned
    assert c5.pin_plan(shape, stride, 2, 2)["path"] == "element"
    assert c5.pin_plan(shape, stride, 2, 32)["path"] == "vec16"
    # a strided last axis: perm (0, 4, 2, 1, 3)
    perm = torch.empty((2, 3, 4, 5, 6)).permute(0, 4, 2, 1, 3)
    plan = c5.pin_plan(tuple(perm.shape), perm.stride(), 4, 0)
    assert plan["path"] == "element" and plan["run"] == 1
    # runs that are not a multiple of 16 bytes (7 x 3 bf16)
    odd = torch.empty((2, 4, 3, 7, 3), dtype=torch.bfloat16).transpose(1, 2)
    assert c5.pin_plan(tuple(odd.shape), odd.stride(), 2, 0)["path"] \
        == "element"
    # a contiguous tensor is one run
    full = c5.pin_plan((2, 3, 4, 8, 8), (768, 256, 64, 8, 1), 4, 0)
    assert full["path"] == "vec16" and full["run"] == 2 * 3 * 4 * 64
    assert full["outer_shape"] == []
    # size-1 axes do not break a run
    assert c5.pin_plan((1, 3, 1, 8, 8), (7, 64, 5, 8, 1), 4, 0)["run"] == 192


@pytest.mark.parametrize("perm", [(0, 2, 1, 3, 4), (0, 4, 2, 1, 3),
                                  (1, 0, 2, 3, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pin_kl_cpu_equals_contiguous(perm, dtype):
    gen = torch.Generator().manual_seed(0)
    src = torch.randn((2, 3, 4, 8, 8), generator=gen).to(dtype)
    view = src.permute(*perm)
    got = c5.pin_kl(view)
    assert got.is_contiguous() and torch.equal(got, view.contiguous())
    # a misaligned base
    off = src.reshape(-1)[1:1 + 2 * 3 * 4 * 7 * 8].reshape(2, 3, 4, 7, 8)
    got = c5.pin_kl(off.permute(*perm))
    assert torch.equal(got, off.permute(*perm).contiguous())
