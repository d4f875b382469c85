"""The backward of the port's conv5 ops (medicalseg_torch.ops.conv5) against
the JAX package's custom VJP, run in interpret mode on the CPU at the
shapes tests/test_pallas_conv5.py uses (eligible for the Pallas dgrad and
the std / mid wgrad kernels), against XLA's VJP of the stock conv, and
against autograd of ``F.conv3d``.

On the CPU the port's autograd Function runs the plain versions of its
kernels; the CUDA kernels behind the same Function are held to those plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
Tolerances: 5e-3 against the Pallas kernels (the JAX tests' own bound for
their MXU path), 1e-4 against XLA's f32 VJP where the sums run over 4096
voxels of O(1) terms (atol scaled by the gradient's magnitude).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from medicalseg_tpu.ops import pallas_conv5 as pc
from medicalseg_torch.ops import conv5 as c5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    default of a thread per core in each of them oversubscribes the
    machine many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(shape_kl, co, seed):
    """x [N, D, Ci, H, W], w [5, 5, 5, Ci, Co], b [Co], g [N, D, Co, H, W]."""
    rng = np.random.RandomState(seed)
    n, d, ci, h, w = shape_kl
    x = rng.randn(*shape_kl).astype(np.float32)
    k = (rng.randn(5, 5, 5, ci, co) / np.sqrt(125 * ci)).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    g = rng.randn(n, d, co, h, w).astype(np.float32)
    return x, k, b, g


def _port_grads(x, k, b, g, kind, dtype=torch.float32, x_grad=True):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(x_grad)
    kt = torch.from_numpy(k).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = c5.conv5_kl(xt, kt, bt, kind)
    y.backward(torch.from_numpy(g).to(dtype))
    return xt.grad, kt.grad, bt.grad


def _assert_close(got, ref, tol, scaled=False):
    ref = np.asarray(ref, dtype=np.float32)
    atol = tol * max(1.0, float(np.abs(ref).max())) if scaled else tol
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=tol)


@pytest.mark.parametrize("kind,ci,co", [("head", 8, 3), ("stem", 1, 16),
                                        ("head", 8, 24), ("head", 16, 16)])
def test_backward_matches_pallas_vjp_and_xla_vjp(kind, ci, co):
    x, k, b, g = _data((1, 4, ci, 8, 128), co, seed=ci + co)
    jx, jk, jb, jg = (jnp.asarray(a) for a in (x, k, b, g))

    def f_pal(x_, k_, b_):
        return jnp.vdot(pc.conv5_kl(x_, k_, b_, kind, True), jg)

    def f_xla(x_, k_, b_):
        return jnp.vdot(pc._conv5_xla_kl(x_, k_, b_), jg)

    pal = jax.grad(f_pal, argnums=(0, 1, 2))(jx, jk, jb)
    xla = jax.grad(f_xla, argnums=(0, 1, 2))(jx, jk, jb)
    got = _port_grads(x, k, b, g, kind)
    for ours, p, r in zip(got, pal, xla):
        _assert_close(ours, p, 5e-3)
        _assert_close(ours, r, 1e-4, scaled=True)


@pytest.mark.parametrize("which,kind,ci,co", [("std", "head", 8, 3),
                                              ("std", "stem", 1, 16),
                                              ("mid", "head", 8, 24),
                                              ("mid", "head", 16, 32)])
def test_wgrad_plain_matches_pallas_wgrad_kernels(which, kind, ci, co):
    """The two Pallas wgrad families called directly (interpret mode)
    against the one plain version that stands beside the port's kernel."""
    x, _, _, g = _data((1, 4, ci, 8, 128), co, seed=3 * ci + co)
    if which == "mid":
        ref = pc._conv5_wgrad_mid_kl(jnp.asarray(x), jnp.asarray(g),
                                     interpret=True)
    else:
        ref = pc._conv5_wgrad_kl(jnp.asarray(x), jnp.asarray(g), kind,
                                 interpret=True)
    got = c5.conv5_wgrad_kl_plain(torch.from_numpy(x), torch.from_numpy(g))
    assert got.shape == (5, 5, 5, ci, co) and got.dtype == torch.float32
    _assert_close(got, ref, 5e-3)
    assert torch.equal(got, c5.conv5_wgrad_kl(torch.from_numpy(x),
                                              torch.from_numpy(g), kind))


@pytest.mark.parametrize("ci,co", [(1, 1), (1, 3), (3, 5), (5, 1), (5, 3)])
@pytest.mark.parametrize("shape", [(2, 3, 7, 6), (1, 1, 2, 9), (1, 6, 5, 3)],
                         ids=["2x3x7x6", "1x1x2x9", "1x6x5x3"])
def test_function_matches_conv3d_autograd_at_odd_shapes(shape, ci, co):
    """dx, dw and db at extents that are multiples of nothing, against
    autograd of ``F.conv3d``."""
    n, d, h, w = shape
    x, k, b, g = _data((n, d, ci, h, w), co, seed=11 * ci + co)
    kind = "stem" if ci == 1 else "head"
    got = _port_grads(x, k, b, g, kind)
    xr, kr, br = (torch.from_numpy(a).requires_grad_(True) for a in (x, k, b))
    F.conv3d(xr.transpose(1, 2), kr.permute(4, 3, 0, 1, 2), br,
             padding=2).transpose(1, 2).backward(torch.from_numpy(g))
    for ours, ref in zip(got, (xr.grad, kr.grad, br.grad)):
        _assert_close(ours, ref.numpy(), 1e-4)


def test_dgrad_plain_is_the_conv_with_flipped_transposed_weight():
    _, k, _, g = _data((2, 3, 6, 5, 7), 4, seed=5)
    gt, kt = torch.from_numpy(g), torch.from_numpy(k)
    wflip = kt.flip(0, 1, 2).transpose(3, 4)
    ref = c5.conv5_kl_plain(gt, wflip, torch.zeros(6))
    got = c5.conv5_dgrad_kl(gt, kt)
    assert got.shape == (2, 3, 6, 5, 7)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_stem_skips_dx_when_the_input_needs_no_gradient(monkeypatch):
    x, k, b, g = _data((1, 3, 1, 4, 8), 16, seed=7)

    def no_dgrad(gk, w):
        raise AssertionError("dgrad ran for an input that needs no gradient")

    monkeypatch.setattr(c5, "conv5_dgrad_kl", no_dgrad)
    dx, dw, db = _port_grads(x, k, b, g, "stem", x_grad=False)
    assert dx is None and dw is not None and db is not None
    with pytest.raises(AssertionError, match="dgrad ran"):
        _port_grads(x, k, b, g, "stem", x_grad=True)


def test_fused_conv_raises_under_grad_and_runs_without():
    x, k, b, _ = _data((1, 2, 3, 4, 5), 4, seed=9)
    xt, kt, bt = (torch.from_numpy(a) for a in (x, k, b))
    ep = (torch.ones(4), torch.zeros(4), torch.ones(4))
    kt.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        c5.conv5_kl_fused(xt, kt, bt, ep)
    with torch.no_grad():
        out = c5.conv5_kl_fused(xt, kt, bt, ep)
    assert not out.requires_grad
    torch.testing.assert_close(out, c5.conv5_kl(xt, kt, bt).detach(),
                               atol=1e-5, rtol=1e-5)


def test_non_contiguous_cotangent_is_pinned():
    x, k, b, g = _data((2, 3, 4, 5, 6), 3, seed=13)
    ref = _port_grads(x, k, b, g, "head")
    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    view = torch.from_numpy(np.ascontiguousarray(
        g.transpose(0, 1, 2, 4, 3))).transpose(3, 4)
    assert not view.is_contiguous()
    c5.conv5_kl(xt, kt, bt).backward(view)
    for ours, r in zip((xt.grad, kt.grad, bt.grad), ref):
        assert torch.equal(ours, r)


def test_pin_is_differentiable_and_pins_its_cotangent():
    x = torch.randn(2, 3, 4, 5, 6, requires_grad=True)
    view = x.transpose(1, 2)
    pinned = c5.pin_kl(view)
    assert pinned.is_contiguous() and pinned.grad_fn is not None
    g = torch.randn(2, 4, 3, 6, 5).transpose(3, 4)
    pinned.backward(g)
    assert torch.equal(x.grad, g.transpose(1, 2))


def test_bf16_operands_round_like_jax():
    """bf16: x, w and g rounded to bf16, f32 sums, dx in bf16 and dw rounded
    to bf16 (the JAX layer casts its kernel first, so its VJP returns a
    bf16 dw); one bf16 ulp at each gradient's magnitude."""
    x, k, b, g = _data((1, 4, 8, 8, 128), 3, seed=17)
    jg = jnp.asarray(g, jnp.bfloat16)

    def f_pal(x_, k_, b_):
        return jnp.vdot(pc.conv5_kl(x_, k_, b_, "head", True).astype(
            jnp.float32), jg.astype(jnp.float32))

    pal = jax.grad(f_pal, argnums=(0, 1, 2))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(b))
    assert pal[1].dtype == jnp.bfloat16
    dx, dw, db = _port_grads(x, k, b, g, "head", dtype=torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.equal(dw, dw.bfloat16().float())  # rounded through bf16
    for ours, p in zip((dx, dw, db), pal):
        _assert_close(ours, np.asarray(p.astype(jnp.float32)), 2e-2,
                      scaled=True)


def test_cpu_backward_launches_nothing():
    c5.reset_launches()
    x, k, b, g = _data((1, 2, 2, 3, 4), 3, seed=19)
    _port_grads(x, k, b, g, "head")
    assert all(v == 0 for v in c5.LAUNCHES.values())
    assert {"conv5_dgrad", "conv5_wgrad_stem", "conv5_wgrad_head",
            "conv5_wgrad_mid"} <= set(c5.LAUNCHES)


@pytest.mark.parametrize("bad", ["extent", "dtype", "stem_ci", "kind",
                                 "dgrad_co"])
def test_backward_wrappers_reject_malformed_operands(bad):
    x, k, _, g = _data((1, 2, 2, 3, 4), 3, seed=21)
    xt, kt, gt = (torch.from_numpy(a) for a in (x, k, g))
    with pytest.raises((ValueError, TypeError)):
        if bad == "extent":
            c5.conv5_wgrad_kl(xt, gt[:, :, :, :2])
        elif bad == "dtype":
            c5.conv5_wgrad_kl(xt, gt.bfloat16())
        elif bad == "stem_ci":
            c5.conv5_wgrad_kl(xt, gt, "stem")
        elif bad == "kind":
            c5.conv5_wgrad_kl(xt, gt, "mid")
        else:
            c5.conv5_dgrad_kl(gt[:, :, :2], kt)


# every conv of the 128^3 batch-2 V-Net, the spine geometry's widest plane,
# and shapes that fill no tile
GEOMETRIES = [(2, 128, 128, 128, 1, 16, "stem", "stem"),
              (2, 128, 128, 128, 32, 3, "head", "head"),
              (2, 128, 128, 128, 32, 32, "head", "mid"),
              (2, 64, 64, 64, 64, 64, "head", "mid"),
              (2, 32, 32, 32, 128, 128, "head", "mid"),
              (2, 16, 16, 16, 256, 256, "head", "mid"),
              (2, 8, 8, 8, 256, 256, "head", "mid"),
              (1, 12, 512, 512, 16, 20, "head", "mid"),
              (1, 5, 7, 100, 24, 33, "head", "mid"),
              (1, 3, 3, 3, 5, 1, "head", "head"),
              (1, 1, 1, 1, 1, 1, "stem", "stem")]


@pytest.mark.parametrize("n,d,h,w,ci,co,kind,form", GEOMETRIES)
def test_wgrad_launch_geometry_fits_the_kernel(n, d, h, w, ci, co, kind,
                                               form):
    q = c5.conv5_wgrad_geometry(n, d, h, w, ci, co, kind)
    assert q["form"] == form
    assert q["threads"] == q["vs"] * q["kdn"] * 5 * q["cig"] * q["cog"]
    assert q["threads"] <= 384 and q["smem"] <= 227 * 1024
    assert q["tw"] % 4 == 0 and q["tw"] >= 4 and 1 <= q["vs"] <= q["th"]
    assert q["ci_t"] == (1 if kind == "stem" else 4)
    assert q["cis"] >= q["ci_t"] * q["cig"] and q["cos"] >= 4 * q["cog"]
    assert q["cos"] % 4 == 0 and (q["ci_t"] == 1 or q["cis"] % 4 == 0)
    tiles = n * d * -(-h // q["th"]) * -(-w // q["tw"])
    per = -(-tiles // q["splits"])
    assert 1 <= q["splits"] <= tiles and per * (q["splits"] - 1) < tiles
    assert q["chan_blocks"] <= 65535


@pytest.mark.parametrize("n,d,h,w,ci,co,kind,form",
                         [g for g in GEOMETRIES if g[6] != "stem"])
def test_wgrad_mma_launch_geometry_fits_the_kernel(n, d, h, w, ci, co, kind,
                                                   form):
    q = c5.conv5_wgrad_mma_geometry(n, d, h, w, ci, co)
    assert q["form"] == form and q["nf"] in (1, 2, 4)
    assert q["tw"] in (8, 16, 32) and 1 <= q["th"] <= 8
    assert q["xcs"] >= (q["th"] + 4) * (q["tw"] + 4) and q["xcs"] % 8 == 4
    assert q["gcs"] >= q["th"] * q["tw"] and q["gcs"] % 8 == 4
    assert q["smem"] == 4 * (32 * q["xcs"] + 8 * q["nf"] * q["gcs"])
    assert q["smem"] <= 227 * 1024 and q["chan_blocks"] <= 65535
    tiles = n * -(-d // 2) * -(-h // q["th"]) * -(-w // q["tw"])
    per = -(-tiles // q["splits"])
    assert 1 <= q["splits"] <= tiles and per * (q["splits"] - 1) < tiles
