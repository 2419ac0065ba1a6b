"""Command-line launcher of the PyTorch port, with ``launch.py``'s surface:

    python -m instant_nsr_pl_tpu_torch.launch --config X.yaml --train|--validate \
        [--resume ckpt] [--resume_weights_only] [--device cpu] [dot.list=overrides]

It runs on ``cuda`` unless ``--device cpu`` is given (and fails without a
card). Runs go to ``<exp_dir>/<name>/<trial>`` as in the JAX package's
launcher (``launch.py:94-119``): ``<trial>`` is ``[tag@]<timestamp>``, and
resuming from a checkpoint inside that layout continues in its trial
directory. ``--resume`` also takes a JAX package checkpoint (``.npz``).
``--test``, ``--predict`` and ``--export`` come with the export slice.
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime

LATER = "comes with the export slice of the PyTorch port (test/predict renders, mesh export)"


def _trial_name(config, args, name):
    if config.get("trial_name"):
        return config["trial_name"]
    if args.resume and not args.resume_weights_only:
        # resuming a run: reuse its trial dir when the checkpoint lives in
        # this exp layout, so checkpoints and logs accumulate
        ckd = os.path.dirname(os.path.abspath(args.resume))
        trial_dir = os.path.dirname(ckd)
        if (os.path.basename(ckd) == "ckpt"
                and os.path.dirname(trial_dir) == os.path.abspath(os.path.join(args.exp_dir, name))):
            return os.path.basename(trial_dir)
    tag = config.get("tag", "") or ""
    return (tag + "@" if tag else "") + datetime.now().strftime("%Y%m%d-%H%M%S")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="path to config yaml")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--predict", action="store_true")
    parser.add_argument("--export", action="store_true")
    parser.add_argument("--resume", default=None, help="checkpoint to resume")
    parser.add_argument("--resume_weights_only", action="store_true",
                        help="load parameters and the grid from --resume, start the rest fresh")
    parser.add_argument("--exp_dir", default="./exp")
    args, extras = parser.parse_known_args(argv)

    for flag in ("test", "predict", "export"):
        if getattr(args, flag):
            sys.exit(f"--{flag} {LATER}")
    if not (args.train or args.validate):
        parser.error("one of --train/--validate is required "
                     "(--test/--predict/--export " + LATER + ")")

    from instant_nsr_pl_tpu_torch.config import dump_config, load_config
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.trainer import Trainer

    config = load_config(args.config, cli_args=extras)
    name = config.get("name", os.path.splitext(os.path.basename(args.config))[0])
    config["trial_name"] = _trial_name(config, args, name)
    exp_dir = os.path.join(args.exp_dir, name, config["trial_name"])
    os.makedirs(os.path.join(exp_dir, "config"), exist_ok=True)
    dump_config(os.path.join(exp_dir, "config", "parsed.yaml"), config)

    dm = datasets.make(config.dataset.name, config.dataset)
    system = systems.make(config.system.name, config, device=args.device)
    trainer = Trainer(config, exp_dir)
    if args.train:
        trainer.fit(system, dm, resume=args.resume, resume_weights_only=args.resume_weights_only)
        return 0
    if not args.resume:
        sys.exit("--validate needs --resume <checkpoint>")
    from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint

    dm.setup("fit")
    system.setup_data(dm.train)
    state = load_checkpoint(args.resume, system.init_state(seed=int(config.get("seed", 42))))
    trainer.validate(system, dm, state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
