"""Command-line launcher of the PyTorch port, with ``launch.py``'s surface:

    python -m instant_nsr_pl_tpu_torch.launch --config X.yaml \
        --train|--validate|--test|--predict|--export \
        [--resume ckpt] [--resume_weights_only] [--device cpu] [dot.list=overrides]

It runs on ``cuda`` unless ``--device cpu`` is given (and fails without a
card). Runs go to ``<exp_dir>/<name>/<trial>`` as in the JAX package's
launcher (``launch.py:94-119``): ``<trial>`` is ``[tag@]<timestamp>``, and
resuming from a checkpoint inside that layout continues in its trial
directory (so a second ``--test`` finds the views it already saved).
``--resume`` also takes a JAX package checkpoint (``.npz``). ``--train``
tests the trained state when it ends (test views, then the mesh), as the
JAX launcher does (``launch.py:152-159``); the other modes need ``--resume``.
Every mode writes ``config/parsed.yaml`` and ``config/raw.yaml`` into the
trial; ``--train`` also copies the git-tracked files of the working
directory into ``code/`` (``utils/callbacks.py``, JAX ``launch.py:149-150``).
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime

MODES = ("train", "validate", "test", "predict", "export")


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

    modes = [m for m in MODES if getattr(args, m)]
    if len(modes) != 1:
        parser.error("exactly one of --train/--validate/--test/--predict/--export is required")
    mode = modes[0]

    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.trainer import Trainer
    from instant_nsr_pl_tpu_torch.utils.callbacks import snapshot_code, snapshot_config

    config = load_config(args.config, cli_args=extras)
    name = config.get("name", os.path.splitext(os.path.basename(args.config))[0])
    config["trial_name"] = _trial_name(config, args, name)
    exp_dir = os.path.join(args.exp_dir, name, config["trial_name"])
    snapshot_config(os.path.join(exp_dir, "config"), config, args.config)
    if mode == "train":
        snapshot_code(os.path.join(exp_dir, "code"))

    dm = datasets.make(config.dataset.name, config.dataset)
    system = systems.make(config.system.name, config, device=args.device)
    trainer = Trainer(config, exp_dir)
    if mode == "train":
        state = trainer.fit(system, dm, resume=args.resume,
                            resume_weights_only=args.resume_weights_only)
        trainer.test(system, dm, state)
        return 0
    if not args.resume:
        sys.exit(f"--{mode} needs --resume <checkpoint>")
    from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint

    dm.setup("fit")
    system.setup_data(dm.train)
    state = load_checkpoint(args.resume, system.init_state(seed=int(config.get("seed", 42))))
    if mode == "export":
        trainer.export(system, state)
    else:
        getattr(trainer, mode)(system, dm, state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
