# Copyright 2026. Apache License 2.0.
"""Deployment inference runner on the GPU.

Counterpart of ``deploy/python/infer.py``, with the same CLI flags and the
same ``deploy.yaml`` schema (written by either package's export CLI).
``DeployConfig`` parses the manifest, ``Predictor`` loads the exported
programs or rebuilds the model from ``model_config``, loads ``params`` and
serves a list of volumes with
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

* ``model`` and ``bucket_models`` name ``torch.export`` programs
  (``.pt2``, written by ``python -m medicalseg_torch.export``). A program
  serves plain batches (``model``) or its bucket at its fixed shape; a
  batch of another size is split into blocks of the program's N, the last
  padded with its last volume. Another entry (the JAX package's
  ``.stablehlo``) or a missing file leaves the module rebuilt from
  ``model_config`` to serve, and the runner logs which path it took; a
  ``.pt2`` that does not load raises. int8 and ``--use_swl`` always take
  the rebuilt module, as in the JAX runner, and so does a ``--precision``
  other than the program's dtype. A program runs on the device it was
  exported on.
* ``params`` is a PyTorch ``state_dict`` (``.pt``) or the JAX layout
  (``.msgpack``, as either package's export and checkpoints write it).
  The weights served are the params file's: they are loaded into the
  program's module too, under the same names.
* ``--device`` is ``cuda`` (default) or ``cpu``. With ``cuda`` and no GPU
  the runner raises; it never carries on on the CPU.
* ``--precision`` names the compute dtype; without it the
  ``model_config``'s ``dtype`` holds.
* Preprocessed volumes stay on the device, and the ``preprocess`` stage
  timer waits for the device before it reads the clock. A non-empty
  ``transforms`` list (host transforms, built from the port's
  ``TRANSFORMS`` registry) runs where the JAX runner runs it, after the
  HU window and resize and before the division by the max, on the host:
  the volume makes one round trip to the host. An empty list keeps it on
  the device.

Run: ``python -m medicalseg_torch.deploy.infer --config deploy.yaml
--image_path scan.nii.gz --precision bf16`` (``--use_swl true``,
``--precision int8``; ``--device cpu`` runs the kernels' plain versions).
"""

import argparse
import codecs
import functools
import os
import time

import numpy as np
import torch
import yaml

import torch.nn.functional as F

from .. import io as medio
from .. import ops
from .. import transforms as _transforms  # noqa: F401 (registers them)
from ..core.sliding_window import sliding_window_inference_batched
from ..cvlibs import manager
from ..cvlibs.config import DTYPES, build_model
from ..utils import get_image_list, logger, quant, strtobool, transplant
from ..utils.msgpack_codec import unpackb
from ..utils.utils import resolve_device, strict_f32

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
        """The host transforms, built from the ``TRANSFORMS`` registry."""
        built = []
        for t in self.dic["Deploy"].get("transforms", []) or []:
            t = dict(t)
            kind = t.pop("type")
            built.append(manager.TRANSFORMS[kind](**t))
        return built

    @property
    def model_file(self):
        name = self.dic["Deploy"].get("model")
        return os.path.join(self._dir, name) if name else None

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

    def bucket_model_file(self, key):
        models = self.dic["Deploy"].get("bucket_models", {}) or {}
        return os.path.join(self._dir, models[key]) if key in models else None


def read_params(path):
    """A ``state_dict`` on the CPU from a ``.pt`` file or from a
    ``.msgpack`` in the JAX layout."""
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            return transplant.state_dict_from_flax(unpackb(f.read()))
    return torch.load(path, map_location="cpu", weights_only=True)


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


class _MainOutput(torch.nn.Module):
    """``net.main_output`` as a module's forward, for
    ``torch.func.functional_call``; its ``state_dict`` names are ``net``'s
    under ``net.``."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net.main_output(x)


class Predictor:
    """Runs the deployed model over a list of volumes. Building one sets
    the port's f32 policy (``utils.strict_f32``)."""

    window_batch = 4  # windows per forward of the sliding-window mode

    def __init__(self, args):
        strict_f32()
        self.args = args
        self.cfg = DeployConfig(args.config)
        self.timer = TimeLogger()
        self.device = resolve_device(args.device)
        if self.cfg.output_op not in ("argmax", "softmax", "none"):
            raise ValueError("output_op must be argmax, softmax or none, "
                             "got {!r}".format(self.cfg.output_op))
        self.transforms = self.cfg.transforms
        self.dtype = PRECISIONS[args.precision] if args.precision else None
        self._state = read_params(self.cfg.params_file)
        self._model = None
        self._qstate = None
        self._bucket_calls = {}  # bucket -> program call or None
        self._program = None
        if not (args.use_swl or self.cfg.shape_buckets):
            self._program = self._load_program(self.cfg.model_file, "model")
        if args.use_swl or args.precision == "int8" or not (
                self._program or self.cfg.shape_buckets):
            self._model = self._rebuild()  # this mode serves through it
        self._warmed = False

    @property
    def model(self):
        """The module rebuilt from ``model_config`` with the params file's
        weights: built with the runner where its mode serves through it,
        else at first use."""
        if self._model is None:
            self._model = self._rebuild()
        return self._model

    def _rebuild(self):
        """The module of ``model_config`` with the params file's weights.
        With int8 weights its parameters stay on the meta device and the
        weights live in ``_qstate``."""
        # built without storage: every tensor comes from the params
        with torch.device("meta"):
            model = build_model(self.cfg.model_config, dtype=self.dtype)
        model.eval()
        if self.args.precision == "int8":
            # quantized on the host at load time; what moves to the device
            # and stays there is int8 + f32 scales
            self._transposed = quant.transposed_conv_weights(model)
            self._qstate = {k: v.to(self.device) for k, v in
                            quant.quantize_state_dict(
                                self._state, self._transposed).items()}
        else:
            model.load_state_dict({k: v.to(self.device) for k, v in
                                   self._state.items()}, assign=True)
        return model

    def _load_program(self, path, what):
        """A call of the exported program at ``path`` with the params
        file's weights, or None where the rebuilt module serves ``what``
        (int8, the sliding window, another precision than the program's, a
        path that is not a ``.pt2`` file or does not exist). Logs which."""
        config_dtype = self.cfg.model_config.get("dtype", torch.float32)
        config_dtype = DTYPES.get(config_dtype, config_dtype)
        reason = None
        if self.args.precision == "int8" or self.args.use_swl:
            reason = "int8" if self.args.precision == "int8" else "--use_swl"
        elif not path or not path.endswith(".pt2"):
            reason = "{} is not a .pt2 program".format(path)
        elif not os.path.exists(path):
            reason = "{} does not exist".format(path)
        elif self.dtype not in (None, config_dtype):
            reason = "--precision {} and a {} program".format(
                self.args.precision, config_dtype)
        if reason is not None:
            logger.info("{}: serving through the module rebuilt from "
                        "model_config ({})".format(what, reason))
            return None
        program = torch.export.load(path)
        user_inputs = program.graph_signature.user_inputs
        shape = next(tuple(n.meta["val"].shape) for n in program.graph.nodes
                     if n.op == "placeholder" and n.name in user_inputs)
        module = program.module()
        devices = {t.device.type for t in module.state_dict().values()}
        if devices != {self.device.type}:
            raise ValueError("{} runs on {}, the runner on {}: export it "
                             "with --device {}".format(
                                 path, devices, self.device,
                                 self.device.type))
        module.load_state_dict({"net." + k: v for k, v in
                                self._state.items()})
        logger.info("{}: serving through the exported program {} at "
                    "{}".format(what, path, list(shape)))
        return functools.partial(_split_pad, module, shape)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _model_call(self, x):
        """The logits of ``x``: the model's ``main_output`` (a
        deep-supervision model runs no auxiliary head); with int8 weights,
        through the state dequantized for this call."""
        if self._qstate is None:
            return self.model.main_output(x)
        state = quant.dequantize_state_dict(self._qstate, self._transposed)
        return torch.func.functional_call(
            _MainOutput(self.model),
            {"net." + k: v for k, v in state.items()}, (x,))

    def _output(self, logits):
        if self.cfg.output_op == "softmax":
            out = torch.softmax(logits, dim=-1)
        elif self.cfg.output_op == "argmax":
            out = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            out = logits
        return out.cpu().numpy()  # .cpu() waits for the device

    def _forward(self, batch, program=None):
        """The output of one batch as a host array: through ``program``
        (its output op inside), else the rebuilt module and the output
        op."""
        with torch.inference_mode():
            x = torch.as_tensor(batch).to(self.device)
            if program is not None:
                return program(x).cpu().numpy()
            return self._output(self._model_call(x))

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
        if bucket not in self._bucket_calls:
            key = "{}x{}x{}".format(*bucket)
            self._bucket_calls[bucket] = self._load_program(
                self.cfg.bucket_model_file(key), "bucket " + key)
        t0 = time.time()
        out = self._forward(torch.cat(vols), self._bucket_calls[bucket])
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
        resolution, resized to the export shape. The manifest's transforms
        then run on the host copy, before the division."""
        if path.endswith(".npy"):
            vol = np.load(path)
        else:
            data, _ = medio.read_image(path)
            # cast on the host, as the JAX runner does; pageable upload
            raw = torch.from_numpy(data.astype(np.float32)).to(self.device)
            if self.args.use_swl:
                vol = ops.hu_norm(raw)
            else:
                vol = ops.hu_norm_resize(raw, self.cfg.input_shape[1:4])
        if self.transforms:
            vol = torch.as_tensor(vol).cpu().numpy()
            for op in self.transforms:
                vol = op(vol)[0]
            vol = np.asarray(vol, np.float32)
        vol = torch.as_tensor(vol).to(self.device)
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
                self._forward(batch, self._program)
                self._warmed = True

            t0 = time.time()
            out = self._forward(batch, self._program)
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


def _split_pad(module, shape, x):
    """``module`` (an exported program of fixed input ``shape``) over a
    batch ``x`` of any size: blocks of the program's N, the last padded
    with copies of its last volume, the outputs cut back to the batch."""
    if tuple(x.shape[1:]) != tuple(shape[1:]):
        raise ValueError("the exported program takes volumes of {}, got "
                         "{}".format(list(shape[1:]), list(x.shape[1:])))
    fixed_n, outs = shape[0], []
    for start in range(0, x.shape[0], fixed_n):
        block = x[start:start + fixed_n]
        k = block.shape[0]
        if k < fixed_n:
            block = torch.cat([block, block[-1:].expand(
                fixed_n - k, *block.shape[1:])])
        outs.append(module(block)[:k])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def main(args):
    imgs = get_image_list(args.image_path)
    predictor = Predictor(args)
    outputs = predictor.run(imgs)
    logger.info("Saved {} predictions to {}".format(
        len(outputs), args.save_dir))


if __name__ == "__main__":
    main(parse_args())
