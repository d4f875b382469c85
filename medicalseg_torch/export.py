# Copyright 2026. Apache License 2.0.
"""Export CLI: the model as a ``torch.export`` program for deployment.

Counterpart of the root ``export.py``, with its flags and its output
directory. The model of the config's ``model`` section, with the weights
of ``--model_path``, is wrapped with the output op (softmax and / or
argmax to int32, as ``export.py`` wraps it), and its eval forward is
exported under ``torch.no_grad()`` with ``torch.export.export`` at the
fixed NDHWC shape of ``--input_shape`` (given NCDHW). The directory then
holds:

* ``model.pt2``, the program (``torch.export.save``), and one
  ``model_DxHxW.pt2`` per ``--shape_buckets`` triple at the same batch;
* ``model.msgpack``, the weights in the JAX package's layout
  (``utils.checkpoint.save_checkpoint``), which either package's runner
  reads;
* ``deploy.yaml`` with the JAX manifest's keys: ``model``, ``params``,
  ``transforms`` (the val dataset's), ``input_shape_ndhwc``,
  ``shape_buckets``, ``bucket_models``, ``output_op`` and
  ``model_config``.

Inside a program the 5^3 convs and the pins are the ``torch.library`` ops
``medicalseg::conv5_fused`` and ``medicalseg::pin`` (``ops/conv5.py``): on
the card they launch the hand-written kernels, on the CPU their plain
versions. A program runs on the device it was exported on (``--device``,
``cuda`` unless ``cpu`` is asked for) and at its fixed shape; the runner
(``deploy/infer.py``) splits and pads other batch sizes.

Unlike the JAX CLI, which logs a warning and writes the manifest when the
export fails, this one raises: a manifest without its program would serve
through another path than the one exported, and hide that the program is
missing.

Run: ``python -m medicalseg_torch.export --config <yml> --model_path
<model.msgpack | .pt> --input_shape 2 1 128 128 128 --shape_buckets 128
128 128 --save_dir out``.
"""

import argparse
import os

import torch
import yaml
from torch import nn


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Model export.")
    parser.add_argument(
        "--config", dest="cfg", help="The config file.", default=None,
        type=str, required=True)
    parser.add_argument(
        "--save_dir", dest="save_dir",
        help="The directory for saving the exported model", type=str,
        default="./output/export")
    parser.add_argument(
        "--model_path", dest="model_path",
        help="The weights to export: a model.msgpack of either package or "
             "a .pt state_dict", type=str, default=None)
    parser.add_argument(
        "--without_argmax", dest="without_argmax",
        help="Do not add the argmax operation at the end of the network",
        action="store_true")
    parser.add_argument(
        "--with_softmax", dest="with_softmax",
        help="Add the softmax operation at the end of the network",
        action="store_true")
    parser.add_argument(
        "--input_shape", nargs="+", type=int, default=None,
        help="Export the model with fixed input shape, e.g. 1 1 128 128 "
             "128 (NCDHW).")
    parser.add_argument(
        "--shape_buckets", nargs="+", type=int, default=None,
        help="Additional D H W triples (e.g. 128 128 128 192 192 96) to "
             "export alongside --input_shape; the runner routes each "
             "volume to the smallest bucket that holds it.")
    parser.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="The device the programs are exported for and run on; cuda "
             "raises when no GPU is present.")
    return parser.parse_args(argv)


class SavedSegmentationNet(nn.Module):
    """The model's ``main_output`` (a deep-supervision model's heads are
    not in the graph) with the output op: softmax over classes
    (``with_softmax``), then argmax to int32 (``with_argmax``). Its
    ``state_dict`` names are the model's under ``net.``."""

    def __init__(self, net, with_softmax=False, with_argmax=True):
        super().__init__()
        self.net = net
        self.with_softmax = with_softmax
        self.with_argmax = with_argmax

    def forward(self, x):
        logits = self.net.main_output(x)
        if self.with_softmax:
            logits = torch.softmax(logits, dim=-1)
        if self.with_argmax:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return logits


def export_program(net, sample, path):
    """``torch.export`` of ``net``'s eval forward at ``sample``'s shape,
    saved to ``path``; returns the ``ExportedProgram``."""
    net.eval()
    with torch.no_grad():
        program = torch.export.export(net, (sample,))
    torch.export.save(program, path)
    return program


def main(args):
    from .cvlibs import Config
    from .utils import (load_entire_model, logger, resolve_device,
                        strict_f32)
    from .utils.checkpoint import save_checkpoint

    strict_f32()
    device = resolve_device(args.device)
    cfg = Config(args.cfg)
    model = cfg.model
    if args.model_path is not None:
        load_entire_model(model, args.model_path)
        logger.info("Loaded trained params of model successfully.")
    model.to(device).eval()

    shape = [1, 1, 128, 128, 128] if args.input_shape is None \
        else list(args.input_shape)
    n, c, d, h, w = shape  # NCDHW on the command line, NDHWC at run time
    output_op = ("softmax" if args.with_softmax else
                 "argmax" if not args.without_argmax else "none")
    net = SavedSegmentationNet(model, args.with_softmax,
                               not args.without_argmax)

    os.makedirs(args.save_dir, exist_ok=True)
    save_checkpoint(args.save_dir, model)

    def export_one(dhw, fname):
        sample = torch.zeros((n, *dhw, c), dtype=torch.float32,
                             device=device)
        export_program(net, sample, os.path.join(args.save_dir, fname))
        logger.info("Exported {} ({} bytes)".format(fname, os.path.getsize(
            os.path.join(args.save_dir, fname))))

    export_one((d, h, w), "model.pt2")
    buckets, bucket_models = [], {}
    if args.shape_buckets:
        if len(args.shape_buckets) % 3:
            raise ValueError("--shape_buckets wants D H W triples")
        flat = args.shape_buckets
        buckets = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
        for bucket in buckets:
            key = "{}x{}x{}".format(*bucket)
            bucket_models[key] = "model_{}.pt2".format(key)
            export_one(bucket, bucket_models[key])

    deploy_info = {"Deploy": {
        "model": "model.pt2",
        "params": "model.msgpack",
        "transforms": cfg.dic.get("val_dataset", {}).get("transforms", []),
        "input_shape_ndhwc": [n, d, h, w, c],
        "shape_buckets": [list(b) for b in buckets],
        "bucket_models": bucket_models,
        "output_op": output_op,
        "model_config": cfg.dic.get("model", {}),
    }}
    with open(os.path.join(args.save_dir, "deploy.yaml"), "w") as f:
        yaml.dump(deploy_info, f)
    logger.info("Model is saved in {}.".format(args.save_dir))


if __name__ == "__main__":
    main(parse_args())
