# Copyright 2026. Apache License 2.0.
"""Deployment inference runner on the GPU.

Counterpart of ``deploy/python/infer.py`` on its plain batch path, with the
same CLI flags and the same ``deploy.yaml`` schema (written by
``export.py``). ``DeployConfig`` parses the manifest, ``Predictor`` rebuilds
the model from ``model_config``, loads ``params`` and runs the batch loop
with optional stage timings (``--benchmark``), an ``output_op`` of
argmax | softmax | none, and ``.npy`` results.

Differences from the JAX runner:

* ``params`` names a PyTorch ``state_dict`` file (``.pt``); the
  ``model`` StableHLO entry is ignored.
* ``--device`` is ``cuda`` (default) or ``cpu``. With ``cuda`` and no GPU
  the runner raises; it never carries on on the CPU.
* ``--precision`` names the compute dtype: ``fp32`` or ``bf16``; without
  it the ``model_config``'s ``dtype`` holds.
* Sliding-window serving, shape buckets, int8 weights, deploy transforms
  and raw medical formats are later slices of the port: each raises
  ``NotImplementedError`` naming its ROADMAP item.

Run: ``python -m medicalseg_torch.deploy.infer --config deploy.yaml
--image_path <dir of .npy> --precision bf16``.
"""

import argparse
import codecs
import os
import time

import numpy as np
import torch
import yaml

from ..cvlibs.config import build_model
from ..utils import get_image_list, logger, strtobool
from ..utils.utils import resolve_device

PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Model deploy inference")
    parser.add_argument(
        "--config", help="The deploy config file (deploy.yaml) path.",
        type=str, required=True)
    parser.add_argument(
        "--image_path", help="The image or directory of images to infer.",
        type=str, required=True)
    parser.add_argument(
        "--batch_size", type=int, default=1, help="Mini batch size.")
    parser.add_argument(
        "--save_dir", type=str, default="./output/deploy",
        help="Directory for the predictions.")
    parser.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="Inference device; cuda raises when no GPU is present.")
    parser.add_argument(
        "--precision", type=str, default=None,
        choices=["fp32", "bf16", "int8"],
        help="Compute dtype; default: the model_config's dtype. int8 "
             "weights are not ported yet.")
    parser.add_argument(
        "--enable_auto_tune", type=strtobool, default=False,
        help="Kept for CLI parity; nothing to tune.")
    parser.add_argument(
        "--benchmark", type=strtobool, default=False,
        help="Log preprocess/inference/postprocess stage timings.")
    parser.add_argument(
        "--with_argmax", dest="with_argmax", action="store_true",
        help="Perform argmax postprocess if the exported net didn't.")
    parser.add_argument(
        "--use_swl", type=strtobool, default=False,
        help="Sliding-window whole-volume inference (not ported yet).")
    return parser.parse_args(argv)


class DeployConfig:
    """deploy.yaml parser."""

    def __init__(self, path):
        with codecs.open(path, "r", "utf-8") as f:
            self.dic = yaml.load(f, Loader=yaml.FullLoader)
        self._dir = os.path.dirname(path)

    @property
    def transforms(self):
        return self.dic["Deploy"].get("transforms", []) or []

    @property
    def params_file(self):
        return os.path.join(self._dir, self.dic["Deploy"]["params"])

    @property
    def model_config(self):
        return self.dic["Deploy"].get("model_config", {})

    @property
    def output_op(self):
        return self.dic["Deploy"].get("output_op", "argmax")

    @property
    def shape_buckets(self):
        return [tuple(b) for b in
                self.dic["Deploy"].get("shape_buckets", []) or []]


class TimeLogger:
    """AutoLog-style stage timer."""

    def __init__(self):
        self.stages = {"preprocess": [], "inference": [], "postprocess": []}

    def record(self, stage, dt):
        self.stages[stage].append(dt)

    def report(self):
        for stage, times in self.stages.items():
            if times:
                logger.info(
                    "[BENCH] {}: mean {:.2f} ms over {} calls".format(
                        stage, 1000 * np.mean(times), len(times)))


class Predictor:
    """Runs the deployed model over a list of volumes."""

    def __init__(self, args):
        self.args = args
        self.cfg = DeployConfig(args.config)
        self.timer = TimeLogger()
        self.device = resolve_device(args.device)
        if args.use_swl:
            raise NotImplementedError(
                "sliding-window serving is not ported yet (ROADMAP, "
                "modules to port, item 9)")
        if self.cfg.shape_buckets:
            raise NotImplementedError(
                "shape-bucket serving is not ported yet (ROADMAP, modules "
                "to port, item 9)")
        if args.precision == "int8":
            raise NotImplementedError(
                "int8 weights are not ported yet (ROADMAP, modules to "
                "port, item 9)")
        if self.cfg.transforms:
            raise NotImplementedError(
                "deploy transforms are not ported yet (ROADMAP, modules "
                "to port, item 7)")
        if self.cfg.output_op not in ("argmax", "softmax", "none"):
            raise ValueError("output_op must be argmax, softmax or none, "
                             "got {!r}".format(self.cfg.output_op))
        dtype = PRECISIONS[args.precision] if args.precision else None
        # built without storage: every tensor comes from the params file
        with torch.device("meta"):
            self.model = build_model(self.cfg.model_config, dtype=dtype)
        state = torch.load(self.cfg.params_file, map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state, assign=True)
        self.model.eval()
        self._warmed = False

    def _forward(self, batch):
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(self.device)
            logits = self.model(x)[0]
            if self.cfg.output_op == "softmax":
                out = torch.softmax(logits, dim=-1)
            elif self.cfg.output_op == "argmax":
                out = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                out = logits
            return out.cpu().numpy()

    def _preprocess(self, path):
        """A ``.npy`` volume normalised by its max, as [1, D, H, W, 1]."""
        if not path.endswith(".npy"):
            raise NotImplementedError(
                "raw medical formats need the ingest port (ROADMAP, "
                "modules to port, item 10): {}".format(path))
        vol = np.asarray(np.load(path), np.float32)
        if vol.max() > 0:
            vol = vol / vol.max()
        return vol[None, ..., None]

    def run(self, imgs):
        if not isinstance(imgs, (list, tuple)):
            imgs = [imgs]
        os.makedirs(self.args.save_dir, exist_ok=True)
        results = []
        for i in range(0, len(imgs), self.args.batch_size):
            chunk = imgs[i:i + self.args.batch_size]
            t0 = time.time()
            batch = np.concatenate([self._preprocess(p) for p in chunk])
            self.timer.record("preprocess", time.time() - t0)

            if not self._warmed:
                # first call loads the kernels and sizes the allocator
                # outside the timed path
                self._forward(batch)
                self._warmed = True

            t0 = time.time()
            out = self._forward(batch)  # .cpu() waits for the device
            self.timer.record("inference", time.time() - t0)

            t0 = time.time()
            if self.args.with_argmax and out.ndim == 5:
                out = out.argmax(axis=-1)
            for j, path in enumerate(chunk):
                name = os.path.splitext(os.path.basename(path))[0]
                save_path = os.path.join(self.args.save_dir, name + ".npy")
                np.save(save_path, out[j])
                results.append(save_path)
            self.timer.record("postprocess", time.time() - t0)
        if self.args.benchmark:
            self.timer.report()
        return results


def main(args):
    imgs = get_image_list(args.image_path)
    predictor = Predictor(args)
    outputs = predictor.run(imgs)
    logger.info("Saved {} predictions to {}".format(
        len(outputs), args.save_dir))


if __name__ == "__main__":
    main(parse_args())
