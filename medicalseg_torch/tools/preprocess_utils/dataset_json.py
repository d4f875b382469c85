# Copyright 2026. Apache License 2.0.
"""MSD dataset.json parsing (copy of
``tools/preprocess_utils/dataset_json.py``)."""

import json
import os


def parse_msd_basic_info(json_path):
    """Return (modalities, labels, dataset_name) from an MSD-style
    dataset.json."""
    with open(json_path, "r", encoding="utf-8") as f:
        info = json.load(f)
    modalities = tuple(info["modality"][str(i)]
                       for i in range(len(info["modality"])))
    labels = {str(k): str(v) for k, v in info["labels"].items()}
    dataset_name = info.get("name", os.path.basename(
        os.path.dirname(json_path)))
    return modalities, labels, dataset_name
