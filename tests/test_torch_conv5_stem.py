"""What the CPU can hold of the bf16 stem kernel (``stem_tc_kernel``,
medicalseg_torch/csrc/conv5_stem.cu): its launch geometry against the
card's limits, the gate that sends a conv to it, its packed weights, and
its operand words (x shifted by ``__byte_perm``, the zero sixth kw, the K
order over (kd, kh, kw pairs)), depth chunks and epilogue emulated in plain
PyTorch, against the plain version and against the JAX package's Pallas
stem in interpret mode. The kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it to the plain version
there).

Tolerances: the emulation against the plain version is float32 on
bf16-representable operands, the same products summed in another order,
before the kernel's one rounding to bf16: atol = rtol = 1e-5, atol scaled
by the output's magnitude. Against the Pallas stem (f32, interpret mode,
fed the same bf16-representable weights) 1e-4, the bound of
tests/test_torch_conv5.py.
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
def _check_geometry(n, d, h, w):
    q = c5.conv5_stem_tc_geometry(n, d, h, w)
    assert (q["th"], q["tw"], q["threads"]) == (8, 32, 256)
    # the chunks cover D, none empty
    assert q["chunks"] * q["dc"] >= d and (q["chunks"] - 1) * q["dc"] < d
    assert q["chunks"] <= -(-d // 8)
    tiles = -(-h // 8) * -(-w // 32)
    assert q["grid"] == (tiles, n * q["chunks"])
    assert q["grid"][0] < 2 ** 31 and q["grid"][1] <= 65535
    # ten slots of 12 x 40 bf16, 8 warps' [16][40] output staging and 4 x
    # 16 f32 channel constants, as static shared memory, twice per SM
    smem = 10 * 12 * 40 * 2 + 8 * 16 * 40 * 2 + 4 * 16 * 4
    assert q["smem"] == smem <= SMEM_STATIC
    assert q["blocks_per_sm"] * q["smem"] <= 227 * 1024
    return q


def test_geometry_vnet_stem():
    """in_tr, 1 -> 16 at 128^3, batch 2: 64 tiles x 2 volumes x 9 depth
    chunks of 15, over 8 blocks an SM."""
    q = _check_geometry(2, 128, 128, 128)
    assert (q["dc"], q["chunks"]) == (15, 9)
    assert q["grid"][0] * q["grid"][1] >= 8 * SMS


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
    (torch.float32, "stem", 17, "stem"),
    (torch.bfloat16, "head", 16, "head"),
    (torch.float32, "head", 3, "head_tf32")])
def test_gate_forms(dtype, kind, co, form):
    x = torch.empty((2, 4, 1, 8, 16), dtype=dtype, device="meta")
    assert c5.conv5_form(x, co, kind) == form


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_main_path_hands_the_stem_to_the_tensor_core_kernel(monkeypatch,
                                                            train):
    """A bf16 V-Net forward on the CPU, the conv wrappers recorded: the
    stem (served with its fused epilogue, trained without) is the one
    conv whose form is 'stem_tc'; every other is 'head'."""
    seen = []
    plain, fused = c5.conv5_kl, c5.conv5_kl_fused

    def record(xk, w, b, kind="head"):
        seen.append((c5.conv5_form(xk, w.shape[4], kind), False))
        return plain(xk, w, b, kind)

    def record_fused(xk, w, b, ep, kind="head"):
        seen.append((c5.conv5_form(xk, w.shape[4], kind), True))
        return fused(xk, w, b, ep, kind)

    monkeypatch.setattr(c5, "conv5_kl", record)
    monkeypatch.setattr(c5, "conv5_kl_fused", record_fused)
    model = VNet(num_classes=3, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(7))
    x = torch.from_numpy(np.random.RandomState(8).rand(
        1, 16, 16, 16, 1).astype(np.float32))
    if train:
        model(x)
    else:
        with torch.inference_mode():
            model.eval()(x)
    assert len(seen) == 16
    assert [s for s in seen if s[0] != "head"] == [("stem_tc", not train)]


# ----------------------------------------------------------------------
# (c) the kernel's operand words, K order, depth chunks and epilogue
# ----------------------------------------------------------------------
def _halves(word):
    """32-bit words -> their (low, high) bf16 values as f32, on a new last
    axis."""
    word = word.to(torch.int64) & 0xFFFFFFFF
    bits = torch.stack([word & 0xFFFF, word >> 16], -1).to(torch.int16)
    return bits.view(torch.bfloat16).float()


def _words(box):
    u = box.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return u[..., 0::2] | (u[..., 1::2] << 16)


def _byte_perm_5432(lo, hi):
    return (lo >> 16) | ((hi & 0xFFFF) << 16)


def _pair_taps():
    """(kd, kh, kp) of each K pair as the kernel's table holds it: pair j <
    75 in row-major order, the 5 padding pairs reading pair 0's words."""
    taps = []
    for j in range(80):
        jj = j if j < 75 else 0
        taps.append((jj // 3 // 5, jj // 3 % 5, jj % 3))
    return taps


def _emulate_stem(xk, w, b, ep, q):
    """The kernel's arithmetic: per block (tile, volume, depth chunk) and
    output depth the five input slices of a 12 x 40 halo tile (zeros
    outside the volume); per warp row and m16 tile the A words of each K
    pair (aligned words at even voxels, __byte_perm of two at odd ones,
    the sixth kw read as x itself and weighted by the packed zero) times
    the packed B words, summed in f32 over the 10 K steps; bias and the
    epilogue in f32. Returns f32 [N, D, Co, H, W] before the kernel's
    rounding to bf16, and how often each output was written."""
    n, d, _, h, ww = xk.shape
    co = w.shape[4]
    tiles_w = -(-ww // 32)
    pw = c5._pack_weights_stem(w)
    bk = _halves(pw)  # [80 pairs, 16 co, 2]
    bmat = bk.permute(0, 2, 1).reshape(160, 16)  # K = 2 * pair + j
    xp = F.pad(xk[:, :, 0], (2, tiles_w * 32 + 8, 2, 16, 2, q["dc"] + 8))
    taps = _pair_taps()
    out = torch.zeros((n, d, 16, h, ww))
    writes = torch.zeros((n, d, 16, h, ww), dtype=torch.int64)
    vox = torch.arange(32)
    for tile in range(q["grid"][0]):
        h0, w0 = tile // tiles_w * 8, tile % tiles_w * 32
        for row_block in range(q["grid"][1]):
            nb, chunk = divmod(row_block, q["chunks"])
            for od in range(chunk * q["dc"], min(d, (chunk + 1) * q["dc"])):
                # slice od - 2 + kd sits at padded depth od + kd
                halo = xp[nb, od:od + 5, h0:h0 + 12, w0:w0 + 40]
                words = _words(halo)  # [5, 12, 20]
                for warp in range(8):
                    a = torch.empty((32, 160))
                    for j, (kd, kh, kp) in enumerate(taps):
                        c = vox + 2 * kp  # tile column of the pair's first x
                        lo = words[kd, warp + kh, c // 2]
                        hi = words[kd, warp + kh, c // 2 + 1]
                        word = torch.where(vox % 2 == 1,
                                           _byte_perm_5432(lo, hi), lo)
                        a[:, 2 * j:2 * j + 2] = _halves(word)
                    y = a @ bmat + F.pad(b.float(), (0, 16 - co))
                    if ep is not None:
                        inv, shift, alpha = (F.pad(v.float(), (0, 16 - co))
                                             for v in ep)
                        y = y * inv + shift
                        y = torch.where(y >= 0, y, y * alpha)
                    oh = h0 + warp
                    if oh >= h:
                        continue
                    cols = slice(w0, min(ww, w0 + 32))
                    out[nb, od, :, oh, cols] = y[:ww - w0].t()
                    writes[nb, od, :, oh, cols] += 1
    return out[:, :, :co], writes[:, :, :co]


def _inputs(shape, co, rng, epilogue):
    n, d, _, h, w = shape
    xk = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16).float()
    wt = torch.from_numpy((rng.randn(5, 5, 5, 1, co) / np.sqrt(125)).astype(
        np.float32)).to(torch.bfloat16).float()
    b = torch.from_numpy(rng.randn(co).astype(np.float32))
    ep = None
    if epilogue:
        ep = tuple(torch.from_numpy(v.astype(np.float32)) for v in (
            0.5 + rng.rand(co), rng.randn(co), rng.rand(co)))
    return xk, wt, b, ep


@pytest.mark.parametrize("epilogue", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("shape,co", [
    ((1, 3, 1, 5, 40), 16),    # two w tiles, the second ragged; H < 8
    ((2, 10, 1, 9, 16), 16),   # two depth chunks, two row tiles
    ((1, 2, 1, 3, 7), 5)])     # Co < 16, W narrower than a half tile
def test_emulated_stem_equals_plain(shape, co, epilogue):
    rng = np.random.RandomState(co + shape[1])
    xk, wt, b, ep = _inputs(shape, co, rng, epilogue)
    n, d, _, h, w = shape
    q = c5.conv5_stem_tc_geometry(n, d, h, w)
    got, writes = _emulate_stem(xk, wt, b, ep, q)
    assert torch.equal(writes, torch.ones_like(writes))  # each output once
    ref = c5.conv5_kl_plain(xk, wt, b, ep)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)


def test_emulated_depth_chunks_do_not_change_the_result():
    """Each output depth is one block's, so the chunking changes which
    block writes it, not the bits."""
    rng = np.random.RandomState(3)
    xk, wt, b, _ = _inputs((1, 9, 1, 4, 16), 16, rng, False)
    q = c5.conv5_stem_tc_geometry(1, 9, 4, 16)
    one = dict(q, dc=9, chunks=1, grid=(q["grid"][0], 1))
    three = dict(q, dc=3, chunks=3, grid=(q["grid"][0], 3))
    assert torch.equal(_emulate_stem(xk, wt, b, None, one)[0],
                       _emulate_stem(xk, wt, b, None, three)[0])


def test_packed_weights_pairs_and_zero_sixth_tap():
    """Pair j = (kd, kh, kp) holds (w[kd, kh, 2 kp], w[kd, kh, 2 kp + 1]),
    zero at kw = 5, zero in the 5 padding pairs and past Co."""
    wt = torch.randn(5, 5, 5, 1, 6)
    pairs = _halves(c5._pack_weights_stem(wt))  # [80, 16, 2]
    wb = wt.to(torch.bfloat16).float()
    for j, (kd, kh, kp) in enumerate(_pair_taps()[:75]):
        assert torch.equal(pairs[j, :6, 0], wb[kd, kh, 2 * kp, 0])
        want = wb[kd, kh, 2 * kp + 1, 0] if kp < 2 else torch.zeros(6)
        assert torch.equal(pairs[j, :6, 1], want)
    assert not pairs[75:].any() and not pairs[:, 6:].any()


def test_byte_perm_gives_the_odd_voxel():
    """An odd voxel's pair (c, c + 1) straddles two words: the high half of
    the first and the low half of the second."""
    row = torch.arange(1, 41, dtype=torch.float32)  # bf16-exact
    words = _words(row)
    for c in range(1, 36, 2):
        got = _halves(_byte_perm_5432(words[c // 2], words[c // 2 + 1]))
        assert got.tolist() == [row[c].item(), row[c + 1].item()]


@pytest.mark.parametrize("epilogue", [False, True], ids=["plain", "fused"])
def test_emulation_matches_pallas_interpret(epilogue):
    """The emulated kernel against the JAX package's stem (the Pallas
    kernel, interpret mode, f32, with its fused epilogue) at a tiny
    shape."""
    rng = np.random.RandomState(21)
    xk, wt, b, ep = _inputs((2, 4, 1, 4, 32), 16, rng, epilogue)
    ref = np.asarray(pc._conv5_stem_kl(
        jnp.asarray(xk.numpy()), jnp.asarray(wt.numpy()),
        jnp.asarray(b.numpy()), interpret=True,
        ep=None if ep is None else tuple(jnp.asarray(v.numpy())
                                         for v in ep)))
    q = c5.conv5_stem_tc_geometry(2, 4, 4, 32)
    got = _emulate_stem(xk, wt, b, ep, q)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
