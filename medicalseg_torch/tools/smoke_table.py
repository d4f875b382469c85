# Copyright 2026. Apache License 2.0.
"""Tables from saved ``chip_smoke.py`` outputs, side by side.

    python3 chip_smoke.py > a.txt; python3 chip_smoke.py > b.txt
    python -m medicalseg_torch.tools.smoke_table a.txt b.txt

Each argument is the standard output of one run (on one card: compare runs
of one machine only). Prints, per file in the order given, the per-shape
forward and input-gradient times of the bf16 head convs (ms, packing
apart where the run reports it, bound, library), the f32 forward, input
and weight gradients beside the CUDA-core kernels they replaced and
strict-f32 cuDNN (the f32 stem also at the spine's, a halo'd and a
ragged shape), the bf16 weight gradients on ragged views, the pin views,
the ``kernels`` line, and the serving and training numbers (the cube step
and the f32 lung and spine recipes', old against new kernels, the
flagship's with and without its augmentation, the augmentation of each
recipe alone and the train CLI's iterations), and the native reader's
batch, device-cache and inflate times beside numpy's. To compare two
commits, unpack the other one with ``git archive <commit> | tar -x -C
build/parent`` and run its ``chip_smoke.py`` on the same card, one after
the other.
"""
import json
import sys


def load(path):
    run = {"convs": {}, "bwd": {}, "ragged": [], "pins": [], "kernels": {},
           "card": None}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                if "," in line and " W" in line and run["card"] is None:
                    run["card"] = line
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            phase = d.get("phase")
            if phase == "kernels" and "conv" in d:
                run["convs"][d["conv"]] = d
            elif phase == "kernels" and "pin" in d:
                run["pins"].append(d)
            elif phase == "kernels_bwd" and "conv" in d:
                run["bwd"][d["conv"]] = d
            elif phase == "kernels_bwd":
                run["ragged"].append(d)
            elif phase in ("build", "serve", "serve_raw", "serve_swl",
                           "train", "train_f32", "train_spine_f32",
                           "train_flagship", "augment",
                           "train_cli", "native"):
                run[phase] = d
            elif "kernels" in d:
                run["kernels"] = {k["name"]: k for k in d["kernels"]}
    return run


def fmt(v, digits=3):
    return "-" if v is None else "{:.{}f}".format(v, digits)


def main(paths):
    runs = [load(p) for p in paths]
    for path, run in zip(paths, runs):
        print("## {} ({})".format(path, run["card"]))
        print("| conv | Ci->Co @edge | fwd ms | fwd+epilogue ms | pack ms | "
              "cold ms | library ms | bound ms | dgrad ms | dgrad pack ms | "
              "dgrad library ms | splits |")
        print("|---|---|---|---|---|---|---|---|---|---|---|---|")
        for name, d in run["convs"].items():
            if d["kind"] != "head":
                continue
            b = run["bwd"].get(name, {})
            geo = d.get("geometry", {})
            print("| {} | {}->{} @{} | {} | {} | {} | {} | {} | {} | {} | {} "
                  "| {} | {} |".format(
                      name, d["ci"], d["co"], d["shape"][1], fmt(d["ms"]),
                      fmt(d["ms_fused"]), fmt(d.get("pack_ms")),
                      fmt(d.get("cold_ms")), fmt(d["library_ms"]),
                      fmt(d["bound_ms"]), fmt(b.get("dgrad_ms")),
                      fmt(b.get("dgrad_pack_ms")),
                      fmt(b.get("dgrad_library_ms")),
                      geo.get("splits", "-")))
        print()
        print("| f32 conv | Ci->Co @edge | fwd ms | fwd+epilogue ms | old "
              "fwd ms | library ms (TF32 on) | dgrad ms | old dgrad ms | "
              "dgrad library ms | wgrad ms | old wgrad ms | wgrad library "
              "ms | bound ms |")
        print("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
        for name, d in run["convs"].items():
            if "f32_ms" not in d:
                continue
            b = run["bwd"].get(name, {})
            print("| {} | {}->{} @{} | {} | {} | {} | {} ({}) | {} | {} | {} "
                  "| {} | {} | {} | {} |".format(
                      name, d["ci"], d["co"], d["shape"][1],
                      fmt(d["f32_ms"]), fmt(d["f32_ms_fused"]),
                      fmt(d["f32_ms_old"]), fmt(d["f32_library_ms"]),
                      fmt(d["f32_library_tf32_ms"]),
                      fmt(b.get("dgrad_f32_ms")),
                      fmt(b.get("dgrad_f32_ms_old")),
                      fmt(b.get("dgrad_f32_library_ms")),
                      fmt(b.get("wgrad_f32_ms")),
                      fmt(b.get("wgrad_f32_ms_old")),
                      fmt(b.get("wgrad_f32_library_ms")),
                      fmt(d["f32_bound_ms"])))
        print()
        if run["ragged"]:
            print("| bf16 ragged-view wgrad | kernel | ms | plain ms | "
                  "library ms | bound ms |")
            print("|---|---|---|---|---|---|")
            for d in run["ragged"]:
                print("| {} {} | {} | {} | {} | {} | {} |".format(
                    d["ragged"], d["shape"], d["kernel"], fmt(d["wgrad_ms"]),
                    fmt(d["wgrad_plain_ms"], 1), fmt(d["wgrad_library_ms"]),
                    fmt(d["bound_ms"], 4)))
            print()
        print("| pin view | ms | contiguous() ms | device ms | contiguous() "
              "device ms | bound ms | path |")
        print("|---|---|---|---|---|---|---|")
        for d in run["pins"]:
            print("| {} | {} | {} | {} | {} | {} | {} |".format(
                d["pin"], fmt(d["ms"], 4), fmt(d["library_ms"], 4),
                fmt(d.get("device_ms"), 4),
                fmt(d.get("library_device_ms"), 4), fmt(d["bound_ms"], 4),
                d.get("path", "-")))
        print()
        print("| kernel | ms | bound ms | plain ms | library ms | launches |")
        print("|---|---|---|---|---|---|")
        for name, k in run["kernels"].items():
            print("| {} | {} | {} | {} | {} | {} |".format(
                name, fmt(k["ms"]), fmt(k["bound_ms"]), fmt(k["plain_ms"], 1),
                fmt(k["library_ms"]), k["launches"]))
        print()
        s, t = run.get("serve", {}), run.get("train", {})
        raw, swl = run.get("serve_raw", {}), run.get("serve_swl", {})
        print("build s {} | serve ms/batch {} {} vol/s {} profile {} | raw "
              "ms/batch {} | swl s {} | train ms/step {} {} no-remat {} "
              "profile {}".format(
                  fmt(run.get("build", {}).get("seconds"), 1),
                  fmt(s.get("ms_per_batch"), 2),
                  [round(v, 2) for v in s.get("ms_per_batch_each", [])],
                  fmt(s.get("vol_per_s"), 1),
                  json.dumps(s.get("profile")),
                  [round(v, 2) for v in raw.get("ms_per_batch_each", [])],
                  fmt(swl.get("seconds")), fmt(t.get("ms_per_step"), 2),
                  [round(v, 2) for v in t.get("ms_per_step_each", [])],
                  fmt(t.get("ms_per_step_no_remat"), 2),
                  json.dumps(t.get("profile"))))
        for phase in ("train_f32", "train_spine_f32"):
            f32 = run.get(phase, {})
            for form in ("new", "old_stems", "old"):
                r = f32.get(form)
                if r:
                    print("{} ({} kernels) ms/step {} device ms {} idle {} "
                          "peak GB {}".format(phase, form,
                                              fmt(r["ms_per_step"], 2),
                                              fmt(r["device_ms"], 2),
                                              fmt(r["idle_share"]),
                                              fmt(r["peak_mem_gb"], 2)))
        f = run.get("train_flagship", {})
        print("flagship ms/step {} {} patches/s {} peak GB {} profile "
              "{}".format(fmt(f.get("ms_per_step"), 2),
                          [round(v, 2) for v in f.get("ms_per_step_each", [])],
                          fmt(f.get("patches_per_s"), 2),
                          fmt(f.get("peak_mem_gb"), 2),
                          json.dumps(f.get("profile"))))
        a, c = run.get("augment", {}), run.get("train_cli", {})
        prof = c.get("iteration_profile") or {}
        print("flagship with augmentation ms/step {} {} idle {} | augment "
              "ms/batch {} | CLI ms/iter {} reader ms {} windows {} "
              "iteration idle {}".format(
                  fmt(f.get("aug_ms_per_step"), 2),
                  [round(v, 2) for v in f.get("aug_ms_per_step_each", [])],
                  fmt(f.get("aug_profile_idle_share")),
                  {k: round(v["ms_per_batch"], 2) for k, v in a.items()
                   if isinstance(v, dict)},
                  fmt(c.get("ms_per_iter_steady"), 1),
                  fmt(c.get("reader_cost_ms_steady"), 2),
                  c.get("windows"), fmt(prof.get("idle_share"))))
        nat = run.get("native", {})
        rd, dc, gz = (nat.get(k, {}) for k in ("reader", "device_cache",
                                                "inflate"))
        print("native reader ({}) batch ms {} (numpy {}) | device cache s "
              "{} (numpy {}) | inflate ms {} (gzip module {})".format(
                  nat.get("backend"), fmt(rd.get("native_ms"), 2),
                  fmt(rd.get("numpy_ms"), 2), fmt(dc.get("native_s")),
                  fmt(dc.get("numpy_s")), fmt(gz.get("native_ms"), 1),
                  fmt(gz.get("gzip_module_ms"), 1)))
        print()


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
