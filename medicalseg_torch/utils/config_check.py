# Copyright 2026. Apache License 2.0.
"""Cross-check num_classes consistency among model/train/val configs and
back-fill where missing (reference: medicalseg/utils/config_check.py:18-59;
a copy of ``medicalseg_tpu/utils/config_check.py``)."""

from . import logger


def config_check(cfg, train_dataset=None, val_dataset=None):
    """Raise when the number of classes is inconsistent across the model
    config and datasets; back-fill dataset num_classes from the model."""
    num_classes_check(cfg, train_dataset, val_dataset)


def num_classes_check(cfg, train_dataset, val_dataset):
    num_classes_set = set()
    if train_dataset and hasattr(train_dataset, "num_classes"):
        num_classes_set.add(train_dataset.num_classes)
    if val_dataset and hasattr(val_dataset, "num_classes"):
        num_classes_set.add(val_dataset.num_classes)
    if cfg.dic.get("model", None) and cfg.dic["model"].get("num_classes",
                                                           None):
        num_classes_set.add(cfg.dic["model"].get("num_classes"))
    if (not cfg.train_dataset_config) and (not cfg.val_dataset_config):
        raise ValueError(
            "One of `train_dataset` or `val_dataset should be given, but "
            "there are none.")
    if len(num_classes_set) == 0:
        raise ValueError(
            "`num_classes` is not found. Please set it in model, "
            "train_dataset or val_dataset")
    elif len(num_classes_set) > 1:
        raise ValueError(
            "`num_classes` is not consistent: {}. Please set it "
            "consistently in model or train_dataset or val_dataset".format(
                num_classes_set))
    else:
        num_classes = num_classes_set.pop()
        if train_dataset:
            train_dataset.num_classes = num_classes
        if val_dataset:
            val_dataset.num_classes = num_classes
        logger.info("num_classes checked: {}".format(num_classes))
