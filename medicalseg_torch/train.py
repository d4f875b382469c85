# Copyright 2026. Apache License 2.0.
"""The port's training CLI: ``python -m medicalseg_torch.train --config
<yml> ...``.

The argparse surface of the root ``train.py`` (the reference's
train.py:26-189) plus ``--device`` (``cuda`` unless asked for ``cpu``),
driving Config -> datasets, model, optimizer, losses -> ``core.train``.
``--do_eval`` evaluates the config's val set at every save point and keeps
the best model under ``<save_dir>/best_model``; ``--use_vdl`` writes
tensorboardX events to ``--save_dir``. ``--loader_mode device_cache``
(``auto``'s choice for a dataset of one volume shape that fits in 1 GiB)
and ``--steps_per_dispatch`` above 1 train through a CUDA graph of the
step on the card; ``--profiler_options`` writes a Chrome trace of a window
of iterations.

Under ``torchrun`` the ranks form a data x space process mesh (one process
a card; ``parallel.init_from_env``): ``--space S`` shards each volume's H
axis over S ranks, the data axis takes the rest of the world, and
``--batch_size`` is per data index (the global batch is ``batch_size x
data``). NCCL where each rank has a card of its own, gloo where ranks
share one (or with ``--device cpu``); the log names the one taken. E.g.
two cards, the lung recipe H-sharded over both::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m medicalseg_torch.train --config \\
        configs/lung_coronavirus/vnet_lung_coronavirus_128_128_128_15k_tpu.yml \\
        --space 2 --iters 100 --save_interval 50 --seed 0

Example, the flagship recipe (its dataset made by
``tools/generate_synthetic_dataset.py``, see the YAML)::

    python -m medicalseg_torch.train \\
        --config configs/synthetic/vnetdeepsup_synspine_15k.yml \\
        --iters 100 --save_interval 50 --log_iters 10 --seed 0

the same with three steps a dispatch and a trace of iterations 10-20
(``<dir>/trace.json``)::

    python -m medicalseg_torch.train \\
        --config configs/synthetic/vnetdeepsup_synspine_15k.yml \\
        --iters 60 --save_interval 30 --log_iters 15 --seed 0 \\
        --steps_per_dispatch 3 --profiler_options \\
        "batch_range=[10,20];profile_path=output/profile;exit_on_finished=false"

and the convergence recipe with evaluation (its dataset made by
``tools/generate_synthetic_dataset.py --style lesions``, see the YAML)::

    python -m medicalseg_torch.train \\
        --config configs/synthetic/vnet_synthetic_conv_1p5k.yml \\
        --do_eval --save_interval 300 --seed 0
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Model training")
    parser.add_argument(
        "--config", dest="cfg", help="The config file.", default=None,
        type=str)
    parser.add_argument(
        "--iters", dest="iters", help="iters for training", type=int,
        default=None)
    parser.add_argument(
        "--batch_size", dest="batch_size",
        help="Mini batch size of one gpu or cpu", type=int, default=None)
    parser.add_argument(
        "--learning_rate", dest="learning_rate",
        help="Learning rate", type=float, default=None)
    parser.add_argument(
        "--save_interval", dest="save_interval",
        help="How many iters to save a model snapshot once during training.",
        type=int, default=1000)
    parser.add_argument(
        "--resume_model", dest="resume_model",
        help="The path of resume model", type=str, default=None)
    parser.add_argument(
        "--save_dir", dest="save_dir",
        help="The directory for saving the model snapshot", type=str,
        default="./output")
    parser.add_argument(
        "--keep_checkpoint_max", dest="keep_checkpoint_max",
        help="Maximum number of checkpoints to save", type=int, default=5)
    parser.add_argument(
        "--num_workers", dest="num_workers",
        help="Num workers for data loader", type=int, default=0)
    parser.add_argument(
        "--do_eval", dest="do_eval",
        help="Eval while training", action="store_true")
    parser.add_argument(
        "--log_iters", dest="log_iters",
        help="Display logging information at every log_iters", type=int,
        default=10)
    parser.add_argument(
        "--use_vdl", dest="use_vdl",
        help="Whether to record the data to TensorBoard during training",
        action="store_true")
    parser.add_argument(
        "--profiler_options", type=str, default=None,
        help="The option of train profiler e.g. "
             '"batch_range=[50,60];profile_path=model.profile"')
    parser.add_argument(
        "--data_format", dest="data_format",
        help="Data format of the model's input; NDHWC, the only one, is "
             "kept for CLI parity.", type=str, default="NDHWC",
        choices=["NDHWC"])
    parser.add_argument(
        "--seed", dest="seed", help="Set the random seed during training.",
        default=None, type=int)
    parser.add_argument(
        "--space", dest="space",
        help="Spatial-partition axis size of the process mesh (1 = pure "
             "data parallel); the ranks come from torchrun.", type=int,
        default=1)
    parser.add_argument(
        "--loader_mode", dest="loader_mode",
        help="Data pipeline mode: auto | device | device_cache | host. "
             "device_cache stages the whole (deduped) dataset in device "
             "memory and ships only index vectors per step.", type=str,
        default="auto", choices=["auto", "device", "device_cache", "host"])
    parser.add_argument(
        "--wire_dtype", dest="wire_dtype",
        help="Host->device wire format for training batches: bfloat16 "
             "(images bf16 + labels uint8) or float32.", type=str,
        default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument(
        "--steps_per_dispatch", dest="steps_per_dispatch",
        help="Train steps per dispatch (on the card, replays of one "
             "CUDA graph of the step); amortizes host dispatch latency. "
             "Must divide log_iters and save_interval.", type=int,
        default=1)
    parser.add_argument(
        "--device", dest="device", help="cuda (default) or cpu.",
        type=str, default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def main(args):
    from .core.train import train
    from .cvlibs import Config
    from .parallel import init_from_env
    from .utils import (config_check, get_sys_env, logger, seed_all,
                        strict_f32)

    strict_f32()
    device, _ = init_from_env(args.device)
    if args.seed is not None:
        seed_all(args.seed)
        logger.info("Set seed to {}".format(args.seed))

    info = ["{}: {}".format(k, v) for k, v in get_sys_env().items()]
    logger.info("\n".join(["", format("Environment Information", "-^48s")] +
                          info + ["-" * 48]))

    if not args.cfg:
        raise RuntimeError("No configuration file specified.")
    cfg = Config(args.cfg, learning_rate=args.learning_rate,
                 iters=args.iters, batch_size=args.batch_size)
    cfg.data_root_path_warning()

    train_dataset = cfg.train_dataset
    if train_dataset is None:
        raise ValueError(
            "The training dataset is not specified in the configuration "
            "file.")
    if len(train_dataset) == 0:
        raise ValueError(
            "The length of train_dataset is 0. Please check if your "
            "dataset is valid")
    val_dataset = cfg.val_dataset if args.do_eval else None
    losses = cfg.loss

    logger.info("\n---------------Config Information---------------\n" +
                str(cfg) + "------------------------------------------------")
    config_check(cfg, train_dataset=train_dataset, val_dataset=val_dataset)

    return train(
        cfg.model,
        train_dataset,
        val_dataset=val_dataset,
        optimizer=cfg.build_optimizer,
        lr_scheduler=cfg.lr_scheduler,
        save_dir=args.save_dir,
        iters=cfg.iters,
        batch_size=cfg.batch_size,
        resume_model=args.resume_model,
        save_interval=args.save_interval,
        log_iters=args.log_iters,
        num_workers=args.num_workers,
        use_vdl=args.use_vdl,
        losses=losses,
        keep_checkpoint_max=args.keep_checkpoint_max,
        profiler_options=args.profiler_options,
        seed=args.seed if args.seed is not None else 0,
        space=args.space,
        data_loader_mode=args.loader_mode,
        steps_per_dispatch=args.steps_per_dispatch,
        wire_dtype=args.wire_dtype,
        device=str(device))


if __name__ == "__main__":
    main(parse_args())
