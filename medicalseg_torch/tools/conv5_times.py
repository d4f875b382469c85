# Copyright 2026. Apache License 2.0.
"""Times of the bf16 head convs of one V-Net forward at 128^3, batch 2, on
the card: the quick loop for work on ``csrc/conv5_wg.cu``.

    python -m medicalseg_torch.tools.conv5_times

Builds ``conv5_wg`` (printing what ``-Xptxas -v`` says of each
instantiation: registers, spills, wgmma warnings), then per shape holds
the fused forward and the input gradient against their plain versions
(bf16, atol = rtol = 2e-2), checks that a second launch gives the same
bits, and prints their times with warm packed weights beside
``F.conv3d`` / ``conv3d_input``, the operation bound and the geometry
that ran; last the sums over one forward / backward. CUDA events, one
warm-up, median of five. Needs one NVIDIA GPU.
"""
import sys

import numpy as np
import torch
import torch.nn.functional as F

from medicalseg_torch.ops import _build
from medicalseg_torch.ops import conv5 as c5

# (name, Ci, Co, edge, convs per forward)
CONVS = [("down_tr32", 32, 32, 64, 1), ("down_tr64", 64, 64, 32, 2),
         ("down_tr128", 128, 128, 16, 3), ("down_tr256", 256, 256, 8, 2),
         ("up_tr256", 256, 256, 16, 2), ("up_tr128", 128, 128, 32, 2),
         ("up_tr64", 64, 64, 64, 1), ("up_tr32", 32, 32, 128, 1),
         ("out_tr", 32, 3, 128, 1)]
BATCH = 2
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        sys.exit("conv5_times: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    log = _build.build(["conv5_wg"])["conv5_wg"].with_suffix(".log")
    lines = log.read_text().splitlines()
    for i, line in enumerate(lines):
        if "(C7" in line:
            print(line[:200])
        if "Compiling entry function" in line and "conv5_wg_kernelILi" in line:
            print("NT=" + line.split("conv5_wg_kernelILi")[1].split("E")[0],
                  lines[i + 2].strip(), lines[i + 3].strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = np.zeros(4)
    for name, ci, co, e, count in CONVS:
        x = torch.randn((BATCH, e, ci, e, e), generator=gen,
                        device=dev).to(torch.bfloat16)
        g = torch.randn((BATCH, e, co, e, e), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = torch.randn((5, 5, 5, ci, co), generator=gen,
                        device=dev) / (125 * ci) ** 0.5
        b = torch.randn((co,), generator=gen, device=dev)
        ep = (0.5 + torch.rand((co,), generator=gen, device=dev),
              torch.randn((co,), generator=gen, device=dev),
              torch.rand((co,), generator=gen, device=dev))
        got, dx = c5.conv5_kl_fused(x, w, b, ep), c5.conv5_dgrad_kl(g, w)
        ok = (torch.allclose(got.float(), c5.conv5_kl_plain(
                  x, w, b, ep).float(), atol=2e-2, rtol=2e-2) and
              torch.allclose(dx.float(), c5.conv5_dgrad_kl_plain(
                  g, w).float(), atol=2e-2, rtol=2e-2))
        same = (torch.equal(got, c5.conv5_kl_fused(x, w, b, ep)) and
                torch.equal(dx, c5.conv5_dgrad_kl(g, w)))
        del got, dx
        ms = time_ms(lambda: c5.conv5_kl_fused(x, w, b, ep))
        ms_d = time_ms(lambda: c5.conv5_dgrad_kl(g, w))
        xn, gn = x.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        wo = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        b16 = b.to(torch.bfloat16)
        lib = time_ms(lambda: F.conv3d(xn, wo, b16, padding=2))
        lib_d = time_ms(lambda: torch.nn.grad.conv3d_input(
            xn.shape, wo, gn, padding=2))
        q = c5.conv5_wg_geometry(BATCH, e, e, e, ci, co)
        flops = 2.0 * BATCH * e ** 3 * 125 * ci * co
        print("{:10s} fwd {:.3f} dgrad {:.3f} library {:.3f} {:.3f} bound "
              "{:.3f} TF/s {:.0f} tile {} nt {} splits {} agrees {} "
              "repeats {}".format(
                  name, ms, ms_d, lib, lib_d, flops / PEAK_BF16 * 1e3,
                  flops / ms / 1e9, (q["td"], q["th"], q["tw"]), q["nt"],
                  q["splits"], ok, same), flush=True)
        total += count * np.array([ms, ms_d, lib, lib_d])
        if not (ok and same):
            sys.exit("conv5_times: {} disagrees with its plain version or "
                     "does not repeat".format(name))
    print("per forward / backward: fwd {:.2f} dgrad {:.2f} library {:.2f} "
          "{:.2f}".format(*total))


if __name__ == "__main__":
    main()
