# Copyright 2026. Apache License 2.0.
"""Deployment inference runner on the GPU.

Counterpart of ``deploy/python/infer.py``, with the same CLI flags and the
same ``deploy.yaml`` schema (written by ``export.py``). ``DeployConfig``
parses the manifest, ``Predictor`` rebuilds the model from
``model_config``, loads ``params`` and serves a list of volumes with
optional stage timings (``--benchmark``), an ``output_op`` of argmax |
softmax | none, and ``.npy`` results. Modes, as in the JAX runner:

* plain batches: a raw scan (NIfTI, MetaImage, NRRD, DICOM) is read on the
  host, uploaded, HU-windowed and resized to the export shape on the
  device (``ops.hu_norm_resize``: the ``hu_resize`` kernel, then the H and
  W passes); a ``.npy`` volume is taken as it is; either is divided by its
  max;
* ``--use_swl``: raw scans keep their native resolution (HU window only)
  and the export shape slides over them with Gaussian blending; consecutive
  same-shape volumes share one window stream, up to ``--batch_size``;
* ``shape_buckets`` in the manifest: each volume is zero-padded into the
  smallest bucket that holds it and the prediction cropped back; a volume
  larger than every bucket is resized to the largest;
* ``--precision int8``: the heavy weights are quantized at load time, live
  on the device as int8 with float32 per-channel scales, and are
  dequantized inside each forward; compute is bf16.

Differences from the JAX runner:

* ``params`` names a PyTorch ``state_dict`` file (``.pt``); the ``model``
  and ``bucket_models`` StableHLO entries are ignored: one rebuilt module
  serves every shape.
* ``--device`` is ``cuda`` (default) or ``cpu``. With ``cuda`` and no GPU
  the runner raises; it never carries on on the CPU.
* ``--precision`` names the compute dtype; without it the
  ``model_config``'s ``dtype`` holds.
* Preprocessed volumes stay on the device, and the ``preprocess`` stage
  timer waits for the device before it reads the clock.
* A non-empty ``transforms`` list in the manifest (host transforms) raises
  ``NotImplementedError`` naming its ROADMAP item.

Run: ``python -m medicalseg_torch.deploy.infer --config deploy.yaml
--image_path scan.nii.gz --precision bf16`` (``--use_swl true``,
``--precision int8``; ``--device cpu`` runs the kernels' plain versions).
"""

import argparse
import codecs
import os
import time

import numpy as np
import torch
import yaml

import torch.nn.functional as F

from .. import io as medio
from .. import ops
from ..core.sliding_window import sliding_window_inference_batched
from ..cvlibs.config import build_model
from ..utils import get_image_list, logger, quant, strtobool
from ..utils.utils import resolve_device

# int8 names the weights' storage; its compute dtype is bf16
PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.bfloat16}


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
        help="Compute dtype; default: the model_config's dtype. int8 = "
             "weight-only int8 with per-channel scales, dequantized "
             "inside each forward, bf16 compute.")
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
        help="Use sliding-window whole-volume inference.")
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
    def input_shape(self):
        return tuple(self.dic["Deploy"].get(
            "input_shape_ndhwc", (1, 128, 128, 128, 1)))

    @property
    def shape_buckets(self):
        """(d, h, w) bucket shapes for variable-size routing."""
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

    window_batch = 4  # windows per forward of the sliding-window mode

    def __init__(self, args):
        self.args = args
        self.cfg = DeployConfig(args.config)
        self.timer = TimeLogger()
        self.device = resolve_device(args.device)
        if self.cfg.transforms:
            raise NotImplementedError(
                "deploy transforms are not read by the runner yet (ROADMAP, "
                "modules to port, item 7: export and the runner's "
                "manifest)")
        if self.cfg.output_op not in ("argmax", "softmax", "none"):
            raise ValueError("output_op must be argmax, softmax or none, "
                             "got {!r}".format(self.cfg.output_op))
        dtype = PRECISIONS[args.precision] if args.precision else None
        # built without storage: every tensor comes from the params file
        with torch.device("meta"):
            self.model = build_model(self.cfg.model_config, dtype=dtype)
        self.model.eval()
        self._qstate = None
        if args.precision == "int8":
            # quantized on the host at load time; what moves to the device
            # and stays there is int8 + f32 scales
            state = torch.load(self.cfg.params_file, map_location="cpu",
                               weights_only=True)
            self._transposed = quant.transposed_conv_weights(self.model)
            self._qstate = {k: v.to(self.device) for k, v in
                            quant.quantize_state_dict(
                                state, self._transposed).items()}
        else:
            state = torch.load(self.cfg.params_file,
                               map_location=self.device, weights_only=True)
            self.model.load_state_dict(state, assign=True)
        self._warmed = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _model_call(self, x):
        """``model(x)``; with int8 weights, through the state dequantized
        for this call."""
        if self._qstate is None:
            return self.model(x)
        state = quant.dequantize_state_dict(self._qstate, self._transposed)
        return torch.func.functional_call(self.model, state, (x,))

    def _output(self, logits):
        if self.cfg.output_op == "softmax":
            out = torch.softmax(logits, dim=-1)
        elif self.cfg.output_op == "argmax":
            out = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            out = logits
        return out.cpu().numpy()  # .cpu() waits for the device

    def _forward(self, batch):
        with torch.inference_mode():
            x = torch.as_tensor(batch).to(self.device)
            return self._output(self._model_call(x)[0])

    # ------------------------------------------------------------------
    # shape-bucket routing
    # ------------------------------------------------------------------
    def _bucket_for(self, dhw):
        """Smallest bucket every dim of ``dhw`` fits into, or None (the
        caller resizes to the largest bucket)."""
        fits = [b for b in self.cfg.shape_buckets
                if all(b[i] >= dhw[i] for i in range(3))]
        if not fits:
            return None
        return min(fits, key=lambda b: b[0] * b[1] * b[2])

    def _run_bucketed(self, pend, results):
        """Zero-pad a same-bucket group to the bucket shape, run it as
        one batch, crop each output back to its native extent."""
        bucket = pend[0][2]
        vols = []
        for _, vol, _ in pend:
            d, h, w = vol.shape[1:4]
            vols.append(F.pad(vol, (0, 0, 0, bucket[2] - w,
                                    0, bucket[1] - h, 0, bucket[0] - d)))
        t0 = time.time()
        out = self._forward(torch.cat(vols))
        self.timer.record("inference", time.time() - t0)
        t0 = time.time()
        for j, (path, vol, _) in enumerate(pend):
            d, h, w = vol.shape[1:4]
            res = out[j][:d, :h, :w]
            if self.args.with_argmax and res.ndim == 4:
                res = res.argmax(axis=-1)
            self._save(path, res, results)
        self.timer.record("postprocess", time.time() - t0)
        pend.clear()

    def _predict_sliding(self, vols):
        """Whole-volume sliding-window inference with Gaussian overlap
        blending (--use_swl) over a same-shape group of [D, H, W] volumes:
        the export shape slides over them at their native resolution, and
        the group shares one window stream."""
        roi = tuple(self.cfg.input_shape[1:4])
        num_classes = int(self.cfg.model_config.get("num_classes", 2))
        volumes = torch.stack(vols)[..., None]
        logits = sliding_window_inference_batched(
            self._model_call, volumes, roi, num_classes=num_classes,
            window_batch=self.window_batch)
        return self._output(logits)

    def _preprocess(self, path):
        """One volume as float32 [1, D, H, W, 1] on the device, divided by
        its max. ``.npy`` passes as it is; a raw medical image is
        HU-windowed and, unless the sliding window will keep its native
        resolution, resized to the export shape."""
        if path.endswith(".npy"):
            vol = torch.from_numpy(np.load(path)).to(self.device)
        else:
            data, _ = medio.read_image(path)
            # cast on the host, as the JAX runner does; pageable upload
            raw = torch.from_numpy(data.astype(np.float32)).to(self.device)
            if self.args.use_swl:
                vol = ops.hu_norm(raw)
            else:
                vol = ops.hu_norm_resize(raw, self.cfg.input_shape[1:4])
        return ops.scale_by_max(vol)[None, ..., None]

    def _save(self, path, out, results):
        name = os.path.splitext(os.path.basename(path))[0]
        save_path = os.path.join(self.args.save_dir, name + ".npy")
        np.save(save_path, out)
        results.append(save_path)

    def _timed_preprocess(self, paths):
        t0 = time.time()
        vols = [self._preprocess(p) for p in paths]
        self._sync()
        self.timer.record("preprocess", time.time() - t0)
        return vols

    def _run_sliding(self, imgs, results):
        """Consecutive same-shape volumes are grouped up to batch_size and
        their windows stream through the model together."""
        pend = []  # (path, vol) with a common shape

        def flush():
            if not pend:
                return
            t0 = time.time()
            out = self._predict_sliding([v for _, v in pend])
            self.timer.record("inference", time.time() - t0)
            t0 = time.time()
            for j, (path, _) in enumerate(pend):
                self._save(path, out[j], results)
            self.timer.record("postprocess", time.time() - t0)
            pend.clear()

        for path in imgs:
            vol = self._timed_preprocess([path])[0][0, ..., 0]
            if pend and vol.shape != pend[0][1].shape:
                flush()
            pend.append((path, vol))
            if len(pend) >= max(1, self.args.batch_size):
                flush()
        flush()

    def _run_buckets(self, imgs, results):
        """Route each volume to the smallest bucket it fits (pad + crop),
        batching consecutive same-bucket volumes."""
        pend = []  # (path, vol, bucket)
        for path in imgs:
            t0 = time.time()
            vol = self._preprocess(path)
            bucket = self._bucket_for(vol.shape[1:4])
            if bucket is None:  # larger than every bucket: resample
                bucket = max(self.cfg.shape_buckets,
                             key=lambda b: b[0] * b[1] * b[2])
                vol = ops.resize3d(vol[0, ..., 0], bucket,
                                   order=1)[None, ..., None]
            self._sync()
            self.timer.record("preprocess", time.time() - t0)
            if pend and bucket != pend[0][2]:
                self._run_bucketed(pend, results)
            pend.append((path, vol, bucket))
            if len(pend) >= max(1, self.args.batch_size):
                self._run_bucketed(pend, results)
        if pend:
            self._run_bucketed(pend, results)

    def _run_batches(self, imgs, results):
        for i in range(0, len(imgs), self.args.batch_size):
            chunk = imgs[i:i + self.args.batch_size]
            batch = torch.cat(self._timed_preprocess(chunk))

            if not self._warmed:
                # first call loads the kernels and sizes the allocator
                # outside the timed path
                self._forward(batch)
                self._warmed = True

            t0 = time.time()
            out = self._forward(batch)
            self.timer.record("inference", time.time() - t0)

            t0 = time.time()
            if self.args.with_argmax and out.ndim == 5:
                out = out.argmax(axis=-1)
            for j, path in enumerate(chunk):
                self._save(path, out[j], results)
            self.timer.record("postprocess", time.time() - t0)

    def run(self, imgs):
        if not isinstance(imgs, (list, tuple)):
            imgs = [imgs]
        os.makedirs(self.args.save_dir, exist_ok=True)
        results = []
        if self.args.use_swl:
            self._run_sliding(imgs, results)
        elif self.cfg.shape_buckets:
            self._run_buckets(imgs, results)
        else:
            self._run_batches(imgs, results)
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
