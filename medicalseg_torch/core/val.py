# Copyright 2026. Apache License 2.0.
"""Evaluation loop.

Counterpart of ``medicalseg_tpu/core/val.py`` (the reference's
medicalseg/core/val.py:29-187) on one device: a batch-size-1 pass over the
val set; per volume an eval-mode forward on the model's device (whole
volume, or the sliding window with ``sw_num``; the model's
``main_output`` alone) with the logits resized back to the label's
shape, the loss and per-channel dice of the config's first loss, and the
argmax's per-class areas; optional AUC-ROC over the
softmax probabilities; the first five volumes dumped as ``.npy`` and
``.nii.gz`` with their dataset.json geometry; a progress bar; and the
result ``{"mdice", "mdice_hard"[, "auc_roc"]}`` with the per-class dice
logged.

The forward, the loss and the areas run under ``torch.inference_mode()``
on the card; each volume's numbers come back to the host once and are
summed there in float64.

Over a process mesh (``mesh``, after the JAX function's volume
distribution) each data index takes a contiguous share of the volumes
(``parallel.process_shard``); on a space axis each volume's forward is
H-sharded over the data index's ranks (halos in the convs) and its logits
are gathered back whole, so the loss, the areas and the dump are those of
the whole volume. ``sw_num`` shards over the data axis only (its windows
stay whole), and ``auc_roc``, which needs every probability in one place,
evaluates the whole set on every rank. The partial sums of the first rank
of each data index are all-reduced in float64; rank 0 alone dumps and
shows the progress bar.
"""

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.collectives import gather_h
from ..parallel.mesh import process_shard, use_mesh
from ..utils import Progbar, TimeAverager, logger, metric, save_array
from ..utils.loss_utils import loss_computation
from . import infer
from .loader import EvalLoader
from .sliding_window import sliding_window_inference_batched

DUMPED = 5  # volumes dumped to save_dir


def _logits(forward, ims, ori_shape, dataset, sw_num):
    """(pred [1, D, H, W] int32, logit [1, D, H, W, C]) of one volume at
    the label's shape ``ori_shape``; ``forward`` gives a batch's
    logits."""
    if not sw_num:
        return infer.inference(forward, ims, ori_shape=ori_shape,
                               transforms=dataset.transforms.transforms)
    roi = tuple(max(1, s // int(sw_num)) for s in ims.shape[1:4])
    logit = sliding_window_inference_batched(
        forward, ims, roi, num_classes=dataset.num_classes)
    if tuple(ori_shape) != tuple(logit.shape[1:4]):
        logit = infer.reverse_transform(logit, ori_shape,
                                        dataset.transforms.transforms)
    return torch.argmax(logit, dim=-1).to(torch.int32), logit


def _image_infor(dataset, dataset_json, idx):
    """The geometry of volume ``idx`` from dataset.json's ``training``
    entry of its file name, unit spacing, zero origin and the identity
    where dataset.json or the entry is missing."""
    infor = {"spacing": (1, 1, 1), "origin": (0, 0, 0),
             "direction": tuple(np.eye(3).reshape(-1))}
    if dataset_json is None:
        return infor
    name = dataset.file_list[idx][0].split("/")[-1].split(".")[0]
    image_json = dataset_json.get("training", {}).get(name, {})
    return {"spacing": image_json.get("spacing_resample", (1, 1, 1)),
            "direction": image_json.get("direction",
                                        tuple(np.eye(3).reshape(-1))),
            "origin": image_json.get("origin", (0, 0, 0))}


class _SpaceSharded:
    """The eval forward of a whole volume with its H axis sharded over the
    space ranks of ``mesh``: the rank's H block through ``model``'s main
    output under the mesh, and the logits gathered back whole."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh

    def main_output(self, ims):
        with use_mesh(self.mesh):
            logits = self.model.main_output(self.mesh.keep_h(ims))
        return gather_h(logits, self.mesh, axis=2)


def evaluate(state,
             eval_dataset,
             losses,
             num_workers=0,
             print_detail=True,
             auc_roc=False,
             writer=None,
             save_dir=None,
             sw_num=None,
             mesh=None):
    """Evaluate ``state.model`` (a :class:`~.state.TrainState`, or
    anything with ``model`` and ``step``) on ``eval_dataset`` with the
    first loss of ``losses``, over ``mesh`` (a ``parallel.Mesh``, every
    rank calling; module docstring) where one is given. ``num_workers`` is
    accepted as the JAX function's and unused (the loader reads in turn).
    The model's train mode is restored on return.

    Returns {"mdice": float, "mdice_hard": float[, "auc_roc": float]},
    the same on every rank.
    """
    new_loss = {"types": [losses["types"][0]], "coef": [losses["coef"][0]]}
    model = state.model
    device = next(model.parameters()).device
    num_classes = eval_dataset.num_classes
    sharded = mesh is not None and mesh.world > 1 and not auc_roc
    primary = mesh is None or mesh.primary
    lo, hi = (process_shard(len(eval_dataset), mesh) if sharded
              else (0, len(eval_dataset)))
    # a space rank's sums repeat its data index's first rank's
    counts = not sharded or mesh.s == 0
    forward = (_SpaceSharded(model, mesh)
               if sharded and mesh.space > 1 and not sw_num
               else model).main_output
    loader = EvalLoader(eval_dataset, start=lo, stop=hi)
    total_iters = len(loader)

    dataset_json = None
    if getattr(eval_dataset, "dataset_json_path", "") and os.path.exists(
            eval_dataset.dataset_json_path):
        with open(eval_dataset.dataset_json_path, "r",
                  encoding="utf-8") as f:
            dataset_json = json.load(f)

    if print_detail:
        logger.info("Start evaluating (total_samples: {}, total_iters: "
                    "{})...".format(len(eval_dataset), total_iters))
    progbar_val = Progbar(target=total_iters, verbose=1)
    reader_cost_averager = TimeAverager()
    batch_cost_averager = TimeAverager()

    mdice_sum = 0.0
    loss_sum = 0.0
    channel_sum = None
    area_sum = np.zeros((3, num_classes), np.float64)
    probs_all, label_all = [], []

    was_training = model.training
    model.eval()
    batch_start = time.time()
    try:
        for i, (im, label, idx) in enumerate(loader):
            reader_cost_averager.record(time.time() - batch_start)
            with torch.inference_mode():
                ims = torch.from_numpy(im).to(device)
                labels = torch.from_numpy(label).to(device).long()
                pred, logit = _logits(forward, ims, labels.shape[1:],
                                      eval_dataset, sw_num)
                loss_list, pcd = loss_computation([logit], labels, new_loss)
                areas = torch.stack(metric.calculate_area(
                    pred[0], labels[0], num_classes,
                    eval_dataset.ignore_index))
                numbers = torch.cat([
                    sum(loss_list).reshape(1).double(), pcd.double(),
                    areas.reshape(-1).double()]).cpu().numpy()
                if auc_roc:
                    probs = torch.softmax(logit.float(), dim=-1)
                    probs_all.append(np.moveaxis(probs.cpu().numpy(), -1,
                                                 1))  # N, C, D, H, W
                    label_all.append(label)
            per_channel_dice = numbers[1:1 + num_classes]
            loss_sum += float(numbers[0])
            mdice_sum += float(np.mean(per_channel_dice))
            area_sum += numbers[1 + num_classes:].reshape(3, num_classes)
            channel_sum = (per_channel_dice.copy() if channel_sum is None
                           else channel_sum + per_channel_dice)

            if i < DUMPED and save_dir is not None and primary:
                save_array(
                    save_path=os.path.join(save_dir, str(i)),
                    save_content={"pred": pred[0].cpu().numpy(),
                                  "label": label[0],
                                  "img": im[0, ..., 0]},
                    form=("npy", "nii.gz"),
                    image_infor=_image_infor(eval_dataset, dataset_json,
                                             idx))

            batch_cost_averager.record(time.time() - batch_start,
                                       num_samples=1)
            if print_detail and primary:
                progbar_val.update(i + 1, [
                    ("batch_cost", batch_cost_averager.get_average()),
                    ("reader cost", reader_cost_averager.get_average())])
            reader_cost_averager.reset()
            batch_cost_averager.reset()
            batch_start = time.time()
    finally:
        model.train(was_training)

    count = float(total_iters)
    if channel_sum is None:
        channel_sum = np.zeros((num_classes if sharded else 1,), np.float64)
    if sharded:
        vec = torch.from_numpy(np.concatenate(
            [[mdice_sum, loss_sum, count], channel_sum,
             area_sum.reshape(-1)]).astype(np.float64) * counts)
        if mesh.backend == "nccl":
            vec = vec.to(device)
        dist.all_reduce(vec)
        vec = vec.cpu().numpy()
        mdice_sum, loss_sum, count = vec[0], vec[1], vec[2]
        channel_sum = vec[3:3 + channel_sum.shape[0]]
        area_sum = vec[3 + channel_sum.shape[0]:].reshape(3, -1)
    count = max(count, 1.0)
    mdice = mdice_sum / count
    channel_dice_array = channel_sum / count
    loss_all = loss_sum / count
    # dataset-level hard dice: 2 * sum(I) / (sum(P) + sum(L)) per class
    # over every evaluated voxel (zero-union classes score 0)
    hard_class_dice, mdice_hard = metric.dice(
        area_sum[0], area_sum[1], area_sum[2])

    result_dict = {"mdice": mdice, "mdice_hard": mdice_hard}
    auc_infor = ""
    if auc_roc:
        auc_value = metric.auc_roc(np.concatenate(probs_all),
                                   np.concatenate(label_all)[:, None],
                                   num_classes=num_classes)
        auc_infor = " Auc_roc: {:.4f}".format(auc_value)
        result_dict["auc_roc"] = auc_value

    if print_detail:
        logger.info(("[EVAL] #Images: {}, Dice: {:.4f}, Dice(argmax): "
                     "{:.4f}, Loss: {:6f}").format(
                         len(eval_dataset), mdice, mdice_hard, loss_all) +
                    auc_infor)
        logger.info("[EVAL] Class dice: \n" + str(
            np.round(channel_dice_array, 4)))
        logger.info("[EVAL] Class dice (argmax): \n" + str(
            np.round(hard_class_dice, 4)))

    if writer is not None:
        writer.add_scalar("Evaluate/Dice", mdice, int(state.step))
        writer.add_scalar("Evaluate/Dice_hard", mdice_hard, int(state.step))
    return result_dict
