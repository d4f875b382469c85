# Copyright 2026. Apache License 2.0.
"""Segmentation metrics.

Counterpart of ``medicalseg_tpu/utils/metric.py`` (the reference's
medicalseg/utils/metric.py:21-210). :func:`calculate_area` counts on the
caller's device (tensors in, tensors out); the aggregations (mIoU, dice,
accuracy, kappa) take the per-class counts on the host as numpy.
:func:`auc_roc` computes the one-vs-rest macro AUC itself, as the
Mann-Whitney statistic with mid-ranks: the value of
``sklearn.metrics.roc_auc_score(..., multi_class="ovr")`` (for two classes
its binary value on column 1), without scikit-learn.

As in the reference, the eval "mDice" headline comes from DiceLoss's
per-channel dice, not from this module.
"""

import numpy as np
import torch


def calculate_area(pred, label, num_classes, ignore_index=255):
    """Per-class intersect / pred / label voxel counts.

    Args:
        pred: integer tensor of predicted class ids, any shape (a
            singleton channel axis of 4-D inputs is squeezed).
        label: integer tensor, same shape as ``pred``.
        num_classes: number of classes C.
        ignore_index: voxels with this label are left out.

    Returns:
        (intersect_area, pred_area, label_area): int64 tensors [C] on
        ``pred``'s device.
    """
    if pred.dim() == 4 and pred.shape[1] == 1:
        pred = pred.squeeze(1)
    if label.dim() == 4 and label.shape[1] == 1:
        label = label.squeeze(1)
    if pred.shape != label.shape:
        raise ValueError(
            "Shape of `pred` and `label` should be equal, "
            "but there are {} and {}.".format(tuple(pred.shape),
                                              tuple(label.shape)))
    pred = pred.reshape(-1, 1).long()
    label = label.reshape(-1, 1).long()
    classes = torch.arange(num_classes, device=pred.device)
    pred_c = (pred == classes) & (label != ignore_index)
    label_c = label == classes
    return ((pred_c & label_c).sum(0), pred_c.sum(0), label_c.sum(0))


def mean_iou(intersect_area, pred_area, label_area):
    """Per-class IoU and mean IoU (reference metric.py:110-135)."""
    intersect_area = np.asarray(intersect_area)
    pred_area = np.asarray(pred_area)
    label_area = np.asarray(label_area)
    union = pred_area + label_area - intersect_area
    class_iou = np.where(union == 0, 0.0,
                         intersect_area / np.maximum(union, 1))
    return class_iou, float(np.mean(class_iou))


def dice(intersect_area, pred_area, label_area):
    """Per-class dice 2I/(P+L) and mean dice (reference metric.py:138-163)."""
    intersect_area = np.asarray(intersect_area)
    pred_area = np.asarray(pred_area)
    label_area = np.asarray(label_area)
    union = pred_area + label_area
    class_dice = np.where(union == 0, 0.0,
                          2 * intersect_area / np.maximum(union, 1))
    return class_dice, float(np.mean(class_dice))


def accuracy(intersect_area, pred_area):
    """Per-class accuracy and overall accuracy (reference metric.py:
    166-188)."""
    intersect_area = np.asarray(intersect_area)
    pred_area = np.asarray(pred_area)
    class_acc = np.where(pred_area == 0, 0.0,
                         intersect_area / np.maximum(pred_area, 1))
    macc = float(np.sum(intersect_area) / max(1, np.sum(pred_area)))
    return class_acc, macc


def kappa(intersect_area, pred_area, label_area):
    """Cohen's kappa coefficient (reference metric.py:191-210)."""
    intersect_area = np.asarray(intersect_area).astype(np.float64)
    pred_area = np.asarray(pred_area).astype(np.float64)
    label_area = np.asarray(label_area).astype(np.float64)
    total_area = np.sum(label_area)
    po = np.sum(intersect_area) / total_area
    pe = np.sum(pred_area * label_area) / (total_area * total_area)
    return float((po - pe) / (1 - pe))


def _binary_auc(positive, score):
    """Area under the ROC curve of ``score`` for the boolean ``positive``:
    the Mann-Whitney U over the product of the class sizes, tied scores
    counting one half (mid-ranks)."""
    from scipy.stats import rankdata
    n_pos = int(positive.sum())
    n_neg = positive.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    ranks = rankdata(score)  # mid-ranks, float64
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0) /
                 (float(n_pos) * n_neg))


def auc_roc(logits, label, num_classes, ignore_index=None):
    """Area under the ROC curve over flattened voxels: one-vs-rest, the
    unweighted mean over the classes; for two classes the binary AUC of
    column 1 (reference metric.py:64-107).

    Accepts (N, C, *spatial) scores (probabilities, for more than two
    classes) and (N, 1, *spatial) labels, as numpy arrays.
    """
    logits = np.asarray(logits)
    label = np.asarray(label)
    if ignore_index is not None or len(np.unique(label)) > num_classes:
        raise RuntimeError("labels with ignore_index is not supported yet.")

    c = logits.shape[1]
    logits = np.moveaxis(logits, 1, -1).reshape(-1, c)
    label = label.reshape(-1)
    if logits.shape[0] != label.shape[0]:
        raise ValueError("length of `logit` and `label` should be equal, "
                         "but they are {} and {}.".format(
                             logits.shape[0], label.shape[0]))
    if num_classes == 2:
        return _binary_auc(label == 1, logits[:, 1])
    classes = np.unique(label)
    if len(classes) != c:
        raise ValueError("Number of classes in y_true not equal to the "
                         "number of columns in 'y_score'")
    if not np.allclose(1, logits.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for "
                         "multiclass roc_auc, i.e. they should sum up to "
                         "1.0 over classes")
    return float(np.mean([_binary_auc(label == k, logits[:, i])
                          for i, k in enumerate(classes)]))
