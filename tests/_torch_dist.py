# Copyright 2026. Apache License 2.0.
"""Multi-process workers for tests/test_torch_parallel.py and
tests/test_torch_parallel_shapes.py.

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

import copy
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
    return finish(start(tmp, jobs, world, env), timeout)


def start(tmp, jobs, world=4, env=None):
    """:func:`launch`'s first half: start the ranks and return a handle
    for :func:`finish`, so that the caller can work meanwhile."""
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
    return tmp, world, procs, logs, time.time()


def finish(handle, timeout=240):
    """Wait for the ranks of :func:`start` (``timeout`` seconds from their
    start) and return their results as :func:`launch` does."""
    tmp, world, procs, logs, started = handle
    deadline = started + timeout
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


def bce_value_and_grad(mesh, p):
    """``BCELoss(**p["kw"])`` of the logits ``p["logits"]`` [N, D, H, W,
    C] against ``p["labels"]``, and its gradient in the logits. With a
    mesh, the rank's rows and H block under it: the global loss, and the
    rank's block of its gradient (each rank back-propagates the loss over
    the world size, as the train step does)."""
    from medicalseg_torch.models.losses import BCELoss
    from medicalseg_torch.parallel import shard_batch, use_mesh
    logits, labels = p["logits"], p["labels"]
    if mesh is not None:
        logits, labels = shard_batch(mesh, logits, labels)
    logits = logits.clone().requires_grad_(True)
    with use_mesh(mesh):
        loss = BCELoss(**p["kw"])(logits, labels)
        (loss / (1 if mesh is None else mesh.world)).backward()
    return {"loss": loss.item(), "grad": logits.grad}


def host_batches(mesh, p):
    """``p["n"]`` host-mode batches of a loader over ``p["phase0"]`` at the
    global batch ``p["batch"]``: the rank's rows with a mesh, all of them
    without."""
    from medicalseg_torch.core.loader import TrainLoader
    from medicalseg_torch.datasets import MedicalDataset
    from medicalseg_torch.transforms import (RandomFlip3D,
                                             RandomResizedCrop3D,
                                             RandomRotation3D)
    transforms = [RandomResizedCrop3D(p["size"], scale=(0.8, 1.2)),
                  RandomRotation3D(20), RandomFlip3D()]
    dataset = MedicalDataset(p["phase0"], p["phase0"], transforms, 3)
    rows = None if mesh is None else mesh.rows(p["batch"] // mesh.data)
    loader = TrainLoader(dataset, p["batch"], num_workers=2, seed=p["seed"],
                         mode="host", rows=rows)
    try:
        return [next(loader) for _ in range(p["n"])]
    finally:
        loader.stop()


def w_train(mesh, p):
    """``core.train.train`` of ``p["config"]`` with the host loader over
    the mesh (``p["batch"]`` a data index); rank 0 returns the final state
    dict, the others the largest difference of theirs from it."""
    import shutil

    import torch.distributed as dist

    from medicalseg_torch.core.train import train
    from medicalseg_torch.cvlibs import Config
    cfg = Config(p["config"], iters=p["iters"])
    save_dir = os.path.join(p["out"], str(mesh.rank))
    state = train(cfg.model, cfg.train_dataset,
                  optimizer=cfg.build_optimizer,
                  lr_scheduler=cfg.lr_scheduler, save_dir=save_dir,
                  iters=p["iters"], batch_size=p["batch"], losses=cfg.loss,
                  num_workers=2, save_interval=p["iters"], log_iters=1,
                  mesh=mesh, data_loader_mode="host", device="cpu")
    shutil.rmtree(save_dir)  # the checkpoints (~360 MB) are not read
    out = {k: v.clone() for k, v in state.model.state_dict().items()}
    worst = 0.0
    for v in out.values():
        ref = v.clone()
        dist.broadcast(ref, 0)
        worst = max(worst, (v.float() - ref.float()).abs().max().item())
    return out if mesh.rank == 0 else {"diff_to_rank0": worst}


_STARTS = {}  # the seeded start of each model a process built


def make_state(p, device="cpu"):
    """The model of payload ``p`` with its state dict (the seeded start
    where the payload has none; built once a process, as a V-Net takes
    seconds to initialise on one thread), SGD with momentum and weight
    decay, a polynomial schedule."""
    from medicalseg_torch.core.state import TrainState
    from medicalseg_torch.cvlibs import config as tconfig
    from medicalseg_torch.models import VNet, VNetDeepSup
    cls = VNetDeepSup if p["deepsup"] else VNet
    if p.get("state_dict") is not None:
        model = cls(**p["model"])
        model.load_state_dict(p["state_dict"])
    else:
        key = (cls, repr(sorted(p["model"].items())))
        if key not in _STARTS:
            _STARTS[key] = cls(**p["model"])
        model = copy.deepcopy(_STARTS[key])
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
           "evaluate": w_evaluate, "bce": bce_value_and_grad,
           "loader": host_batches, "train": w_train}


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
