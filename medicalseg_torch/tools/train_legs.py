# Copyright 2026. Apache License 2.0.
"""The checkpoint that the next leg of a long training run resumes from.

    python -m medicalseg_torch.tools.train_legs SAVE_DIR

prints ``--resume_model <path>`` for the newest ``iter_N`` under SAVE_DIR
that :func:`~medicalseg_torch.utils.checkpoint.is_valid_checkpoint`
accepts, and nothing when there is none (the incomplete ones it passes
over are named on stderr). A SIGTERM during a write leaves at most a
``.tmp`` file, or an ``iter_N`` without ``opt.msgpack``, which it passes
over. Each leg is bounded by ``timeout`` and can be carried on by the same
command, as the repo's ``run-spine-flagship.sh`` does; the flagship study:

    python tools/generate_synthetic_dataset.py --root data --num_volumes 40 \\
        --style spine --name synspine2 --seed 7 --val_frac 0.1
    mkdir -p build/synspine15k
    timeout -k 60 3300 python -m medicalseg_torch.train \\
        --config configs/synthetic/vnetdeepsup_synspine_15k.yml \\
        --save_dir build/synspine15k --save_interval 500 --log_iters 50 \\
        --do_eval --keep_checkpoint_max 3 --seed 7 \\
        $(python -m medicalseg_torch.tools.train_legs build/synspine15k) \\
        2>&1 | tee -a build/synspine15k/train.log
"""

import os
import sys

from ..utils.checkpoint import is_valid_checkpoint


def newest_checkpoint(save_dir):
    """The newest ``iter_N`` under ``save_dir`` that is a complete,
    resumable checkpoint, or None."""
    if not os.path.isdir(save_dir):
        return None
    found = []
    for name in os.listdir(save_dir):
        tail = name[len("iter_"):]
        if name.startswith("iter_") and tail.isdigit():
            found.append((int(tail), os.path.join(save_dir, name)))
    for _, path in sorted(found, reverse=True):
        if is_valid_checkpoint(path):
            return path
        print("Skipping incomplete checkpoint {}".format(path),
              file=sys.stderr)
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: python -m medicalseg_torch.tools.train_legs "
                 "SAVE_DIR")
    path = newest_checkpoint(argv[0])
    if path is not None:
        print("--resume_model {}".format(path))


if __name__ == "__main__":
    main()
