# Copyright 2026. Apache License 2.0.
"""The port's evaluation CLI: ``python -m medicalseg_torch.val --config
<yml> --model_path <model.msgpack | iter_N | model.pt> ...``.

The argparse surface of the root ``val.py`` (the reference's
val.py:25-121) plus ``--device`` (``cuda`` unless asked for ``cpu``):
loads the config and the trained weights (a ``model.msgpack`` written by
either package, or a ``.pt`` ``state_dict`` of the port), optionally
rounds the weights through a serving precision (``--weights_precision
int8`` or ``bf16``), and evaluates the config's val set with
``core.val.evaluate``: whole volumes, or the sliding window with
``--sw_num``, AUC-ROC with ``--auc_roc true``, the first five volumes
dumped under ``--save_dir``, tensorboardX events there with
``--use_vdl``. Under ``torchrun`` the ranks (one a card) share the volumes
out over the data axis of a process mesh of the whole world, as the root
``val.py`` evaluates over ``build_mesh()``; rank 0 dumps and logs, and
every rank returns the same result::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m medicalseg_torch.val --config <yml> --model_path <model.msgpack>

Example::

    python -m medicalseg_torch.val \\
        --config configs/synthetic/vnet_synthetic_conv_1p5k.yml \\
        --model_path output/best_model/model.msgpack
"""

import argparse

from .utils.utils import strtobool


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Model evaluation")
    parser.add_argument(
        "--config", dest="cfg", help="The config file.", default=None,
        type=str)
    parser.add_argument(
        "--model_path", dest="model_path",
        help="The path of model for evaluation", type=str, default=None)
    parser.add_argument(
        "--save_dir", dest="save_dir",
        help="The directory for saving the evaluated results", type=str,
        default="./output/result")
    parser.add_argument(
        "--num_workers", dest="num_workers",
        help="Num workers for data loader", type=int, default=0)
    parser.add_argument(
        "--use_vdl", dest="use_vdl",
        help="Whether to record the result to TensorBoard during evaluation",
        action="store_true")
    parser.add_argument(
        "--auc_roc", dest="auc_roc", help="Whether to use auc_roc metric",
        type=strtobool, default=False)
    parser.add_argument(
        "--sw_num", dest="sw_num",
        help="sliding window number: run sliding-window whole-volume "
             "inference with this many windows per axis (None disables).",
        type=int, default=None)
    parser.add_argument(
        "--weights_precision", dest="weights_precision",
        choices=["fp32", "bf16", "int8"], default="fp32",
        help="int8: round-trip the heavy weights through the serving "
             "runner's weight-only int8 quantization (utils/quant.py) "
             "before evaluating; bf16: round every parameter through "
             "bfloat16. Measures the accuracy cost of those serving modes.")
    parser.add_argument(
        "--device", dest="device", help="cuda (default) or cpu.",
        type=str, default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def main(args):
    """Evaluate as ``args`` say; returns ``evaluate``'s result dict."""
    from .core.state import TrainState
    from .core.val import evaluate
    from .cvlibs import Config
    from .parallel import build_mesh, init_from_env
    from .utils import config_check, get_sys_env, load_entire_model, logger
    from .utils import strict_f32
    from .utils.quant import round_trip_parameters

    strict_f32()
    device, _ = init_from_env(args.device)
    info = ["{}: {}".format(k, v) for k, v in get_sys_env().items()]
    logger.info("\n".join(["", format("Environment Information", "-^48s")] +
                          info + ["-" * 48]))

    if not args.cfg:
        raise RuntimeError("No configuration file specified.")
    cfg = Config(args.cfg)
    val_dataset = cfg.val_dataset
    if val_dataset is None:
        raise RuntimeError(
            "The verification dataset is not specified in the "
            "configuration file.")
    elif len(val_dataset) == 0:
        raise ValueError(
            "The length of val_dataset is 0. Please check if your dataset "
            "is valid")

    logger.info("\n---------------Config Information---------------\n" +
                str(cfg) + "------------------------------------------------")
    config_check(cfg, val_dataset=val_dataset)

    state = TrainState.create(cfg.model, cfg.build_optimizer,
                              cfg.lr_scheduler, device=str(device))
    if args.model_path:
        load_entire_model(state.model, args.model_path)
        logger.info("Loaded trained params of model successfully")
    if args.weights_precision != "fp32":
        round_trip_parameters(state.model, args.weights_precision)
        logger.info("Rounded the parameters through {} for evaluation".format(
            args.weights_precision))

    mesh = build_mesh()
    log_writer = None
    if args.use_vdl and mesh.primary:
        from tensorboardX import SummaryWriter
        log_writer = SummaryWriter(args.save_dir)
    try:
        return evaluate(state, val_dataset, cfg.loss,
                        num_workers=args.num_workers, print_detail=True,
                        auc_roc=args.auc_roc, writer=log_writer,
                        save_dir=args.save_dir, sw_num=args.sw_num,
                        mesh=mesh)
    finally:
        if log_writer is not None:
            log_writer.close()


if __name__ == "__main__":
    main(parse_args())
