# Copyright 2026. Apache License 2.0.
"""Multi-process workers for tests/test_torch_parallel.py.

This module imports only torch, numpy and medicalseg_torch: a worker is a
fresh ``python`` process running this file, so it never imports JAX (a
worker spawned from a test module would import that module, and
tests/conftest.py would set JAX up with 8 virtual devices). The ranks
join a gloo process group through a ``FileStore`` in the test's temporary
directory, so that parallel test processes never share a port, and run
torch on one thread each.

:func:`launch` starts ``world`` ranks on a list of jobs (saved with
``torch.save``), each a worker on a payload over a mesh of the world, and
returns each rank's results.
"""

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(tmp, jobs, world=4, timeout=240, env=None):
    """Run ``jobs`` on ``world`` CPU ranks and return each rank's results
    (a list of each job's result, in job order), in rank order. A job is
    (worker name, space, payload): the worker runs on this rank's cell of
    a data x ``space`` mesh of the world. Raises with the ranks' output if
    any rank fails or the run outlasts ``timeout`` seconds; no rank
    outlives the call."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    torch.save(jobs, os.path.join(tmp, "jobs.pt"))
    for stale in ["store"] + ["out{}.pt".format(r) for r in range(world)]:
        if os.path.exists(os.path.join(tmp, stale)):
            os.remove(os.path.join(tmp, stale))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               **(env or {}))
    logs = [open(os.path.join(tmp, "rank{}.log".format(r)), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), tmp],
        env=env, cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.returncode not in (None, 0)
                                              for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for r, f in enumerate(logs):
        f.seek(0)
        out.append("--- rank {} (rc {}) ---\n{}".format(
            r, procs[r].returncode, f.read()[-1500:]))
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("ranks failed:\n" + "\n".join(out))
    return [torch.load(os.path.join(tmp, "out{}.pt".format(r)),
                       weights_only=False)
            for r in range(world)]


# ----------------------------------------------------------------------
# workers: fn(mesh, payload) -> a result torch.save can write
# ----------------------------------------------------------------------
def w_halo(mesh, p):
    """halo_h of the rank's H block, without gradients and, where the
    block holds ``rows`` rows, differentiable (``p["g"][s]`` is the
    cotangent of space rank s's extended block)."""
    from medicalseg_torch.parallel import halo_h
    x = mesh.keep_h(p["x"], 3).clone().requires_grad_(True)
    with torch.no_grad():
        out = {"plain": halo_h(x.detach(), mesh, p["rows"])}
    if x.shape[3] >= p["rows"]:
        y = halo_h(x, mesh, p["rows"])
        y.backward(p["g"][mesh.s])
        out.update(y=y.detach(), dx=x.grad)
    return out


def w_conv5(mesh, p):
    """conv5_kl forward, backward and fused forward on the rank's rows and
    H block; dW and db summed over the world."""
    from medicalseg_torch.ops import conv5 as c5
    from medicalseg_torch.parallel import shard_batch, use_mesh
    xk, gk = shard_batch(mesh, p["x"], p["g"], spatial_axis=3)
    xk = xk.clone().requires_grad_(p["kind"] == "head")
    w = p["w"].clone().requires_grad_(True)
    b = p["b"].clone().requires_grad_(True)
    with use_mesh(mesh):
        y = c5.conv5_kl(xk, w, b, p["kind"])
        y.backward(gk)
        with torch.no_grad():
            yf = c5.conv5_kl_fused(xk.detach(), w.detach(), b.detach(),
                                   p["ep"], p["kind"])
    dw, db = w.grad.clone(), b.grad.clone()
    torch.distributed.all_reduce(dw)
    torch.distributed.all_reduce(db)
    return {"y": y.detach(), "dx": xk.grad, "dw": dw, "db": db, "yf": yf}


def _losses(n_heads):
    from medicalseg_torch.models import losses as tlosses
    mixed = [tlosses.MixedLoss(
        [tlosses.CrossEntropyLoss(), tlosses.DiceLoss()], [1.0, 1.0])
        for _ in range(n_heads)]
    return {"types": mixed, "coef": [1.0 / n_heads] * n_heads}


def make_state(p, device="cpu"):
    """The model of payload ``p`` with its state dict, SGD with momentum
    and weight decay, a polynomial schedule."""
    from medicalseg_torch.core.state import TrainState
    from medicalseg_torch.cvlibs import config as tconfig
    from medicalseg_torch.models import VNet, VNetDeepSup
    cls = VNetDeepSup if p["deepsup"] else VNet
    model = cls(**p["model"])
    model.load_state_dict(p["state_dict"])
    return TrainState.create(
        model, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9,
                                          weight_decay=1e-4),
        tconfig.polynomial_decay(0.01, 20, 0.0, 0.9), seed=p["seed"],
        device=device)


def step_result(state, metrics):
    return {"loss": metrics["loss"].item(),
            "loss_list": metrics["loss_list"].clone(),
            "dice": metrics["per_channel_dice"].clone(),
            "grads": {k: v.grad.clone() for k, v in
                      state.model.named_parameters() if v.grad is not None},
            "state": {k: v.clone() for k, v in
                      state.model.state_dict().items()}}


def w_step(mesh, p):
    """One train step of the rank's rows of the global batch. Rank 0
    returns its gradients, parameters and statistics; every other rank
    the largest difference of each from rank 0's (a V-Net's state is
    ~180 MB)."""
    import torch.distributed as dist

    from medicalseg_torch.core.state import make_train_step
    from medicalseg_torch.parallel import shard_batch
    state = make_state(p)
    state.generator.manual_seed(p["seed"])
    images, labels = shard_batch(mesh, p["images"], p["labels"],
                                 spatial_axis=None)
    step = make_train_step(_losses(4 if p["deepsup"] else 1), mesh=mesh)
    state, metrics = step(state, images, labels)
    out = step_result(state, metrics)
    diffs = {}
    for kind in ("grads", "state"):
        for k, v in sorted(out[kind].items()):
            ref = v.clone()
            dist.broadcast(ref, 0)
            diffs[kind + ":" + k] = (v.float() - ref.float()).abs().max()
    if mesh.rank:
        del out["grads"], out["state"]
        out["diff_to_rank0"] = max(diffs.values()).item()
    return out


def w_evaluate(mesh, p):
    """``core.val.evaluate`` of the config's val set over the mesh."""
    from medicalseg_torch.core.state import TrainState
    from medicalseg_torch.core.val import evaluate
    from medicalseg_torch.cvlibs import Config
    from medicalseg_torch.utils import load_entire_model
    cfg = Config(p["config"])
    state = TrainState.create(cfg.model, cfg.build_optimizer,
                              cfg.lr_scheduler, device="cpu")
    load_entire_model(state.model, p["model_path"])
    save_dir = os.path.join(p["out"], "rank{}".format(mesh.rank))
    return evaluate(state, cfg.val_dataset, cfg.loss, save_dir=save_dir,
                    mesh=mesh, sw_num=p.get("sw_num"),
                    auc_roc=p.get("auc_roc", False), print_detail=False)


WORKERS = {"halo": w_halo, "conv5": w_conv5, "step": w_step,
           "evaluate": w_evaluate}


def main(rank, world, tmp):
    import torch.distributed as dist

    from medicalseg_torch.parallel import build_mesh, init_process_group
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    init_process_group(rank, world, "cpu", store=store)
    try:
        jobs = torch.load(os.path.join(tmp, "jobs.pt"), weights_only=False)
        # every rank builds every mesh (and its groups) in one order
        meshes = {space: build_mesh(space=space)
                  for space in sorted({job[1] for job in jobs})}
        out = [WORKERS[name](meshes[space], payload)
               for name, space, payload in jobs]
        torch.save(out, os.path.join(tmp, "out{}.pt".format(rank)))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
