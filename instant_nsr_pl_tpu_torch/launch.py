"""Command-line launcher of the PyTorch port, with ``launch.py``'s surface:

    python -m instant_nsr_pl_tpu_torch.launch --config X.yaml \
        --train|--validate|--test|--predict|--export \
        [--resume ckpt] [--resume_weights_only] [--device cpu] \
        [--devices N|all [--backend nccl|gloo]] \
        [--coordinator host:port --num_processes N --process_id I] [dot.list=overrides]

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

Data parallel (the reference's DDP role, JAX ``launch.py:24-71,130-144``):
``--devices N`` starts N rank processes on this host (``torch.multiprocessing``
with the spawn start method: CUDA cannot run in a forked child), rank r on
card r, joined over NCCL (gloo with ``--device cpu``) and trained through
``parallel.DataParallelPlan``; the launcher waits for them, and a rank that
fails stops the others and makes the launcher fail. ``--devices`` above the
visible cards raises unless ``--backend gloo`` is named: then ranks share
cards round-robin (NCCL refuses two ranks on one card). ``--coordinator`` /
``--num_processes`` / ``--process_id`` (or the ``NSR_*`` variables) make
this process one rank of a run started on several hosts. The kernels are
built once, before the ranks start.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
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


def _parser():
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
    parser.add_argument("--devices", default=None,
                        help="data-parallel ranks on this host: a count or 'all' (the "
                             "visible cards)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend (default nccl on cuda, gloo on cpu)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port (or a tcp:// / file:// URL) of rank 0's rendezvous")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser


def _world_size(args):
    """The rank count ``--devices`` asks for (None without the flag);
    raises where the cards cannot hold that many ranks."""
    if args.devices is None:
        return None
    import torch

    cuda = (args.device or "cuda").startswith("cuda")
    cards = torch.cuda.device_count() if cuda else 0
    if args.devices == "all":
        if not cuda:
            raise ValueError("--devices all counts the visible cards; on the CPU give a number")
        n = cards
    else:
        n = int(args.devices)
    if n < 1:
        raise ValueError(f"--devices {args.devices}: at least one rank")
    if cuda and n > cards and args.backend != "gloo":
        raise ValueError(f"--devices {n} exceeds the {cards} visible card(s): NCCL takes one "
                         "rank per card; pass --backend gloo to share cards round-robin")
    return n


def main(argv=None, rank_hook=None):
    """Run the launcher; returns 0. ``rank_hook(system, trainer)`` (a
    picklable callable) is called on every rank once its system and
    trainer are built, before the mode runs: in-process callers observe the
    ranks through it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = _parser()
    args, extras = parser.parse_known_args(argv)
    modes = [m for m in MODES if getattr(args, m)]
    if len(modes) != 1:
        parser.error("exactly one of --train/--validate/--test/--predict/--export is required")
    n = _world_size(args)
    if n is None or args.coordinator or args.process_id is not None:
        return _run(args, extras, rank_hook=rank_hook)
    if (args.device or "cuda").startswith("cuda"):
        from instant_nsr_pl_tpu_torch.ops import cuda_build

        cuda_build.build_all()  # once here, not in every rank
    rdzv = tempfile.mkdtemp(prefix="nsr_rdzv_")
    try:
        dist_args = (f"file://{os.path.join(rdzv, 'store')}", n)
        if n == 1:
            return _run(args, extras, rank=0, dist_args=dist_args, rank_hook=rank_hook)
        import torch.multiprocessing as mp

        # a rank that raises stops the others and raises here
        mp.start_processes(_rank_main, args=(argv, dist_args, rank_hook), nprocs=n,
                           join=True, start_method="spawn")
        return 0
    finally:
        shutil.rmtree(rdzv, ignore_errors=True)


def _rank_main(rank, argv, dist_args, rank_hook):
    args, extras = _parser().parse_known_args(argv)
    _run(args, extras, rank=rank, dist_args=dist_args, rank_hook=rank_hook)


def _run(args, extras, rank=None, dist_args=None, rank_hook=None):
    """The launcher's work in this process: as rank ``rank`` of the
    ``dist_args`` (init method, world size) run, as a rank of the run the
    flags or ``NSR_*`` variables describe, or alone."""
    mode = next(m for m in MODES if getattr(args, m))
    import torch.distributed as dist

    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.parallel.distributed import (
        Group,
        maybe_initialize_distributed,
        rank_device,
    )
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.trainer import Trainer
    from instant_nsr_pl_tpu_torch.utils.callbacks import snapshot_code, snapshot_config

    if dist_args is not None:
        init_method, world = dist_args
        joined = maybe_initialize_distributed(init_method, world, rank, backend=args.backend,
                                              device=args.device)
    else:
        joined = maybe_initialize_distributed(args.coordinator, args.num_processes,
                                              args.process_id, backend=args.backend,
                                              device=args.device)
    try:
        device = args.device
        group = None
        if joined:
            device = rank_device(args.device, dist.get_rank())
            group = Group(device)
        config = load_config(args.config, cli_args=extras)
        name = config.get("name", os.path.splitext(os.path.basename(args.config))[0])
        trial = _trial_name(config, args, name)
        # the ranks' clocks may cross a second: rank 0's trial for all
        config["trial_name"] = group.broadcast_object(trial) if group else trial
        exp_dir = os.path.join(args.exp_dir, name, config["trial_name"])
        is_main = group is None or group.rank == 0
        if is_main:
            snapshot_config(os.path.join(exp_dir, "config"), config, args.config)
            if mode == "train":
                snapshot_code(os.path.join(exp_dir, "code"))

        dm = datasets.make(config.dataset.name, config.dataset)
        system = systems.make(config.system.name, config, device=device)
        if group is not None:
            system.configure_parallel(group)
        trainer = Trainer(config, exp_dir)
        if rank_hook is not None:
            rank_hook(system, trainer)
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
        state = system.replicate(load_checkpoint(
            args.resume, system.init_state(seed=int(config.get("seed", 42)))))
        if mode == "export":
            trainer.export(system, state)
        else:
            getattr(trainer, mode)(system, dm, state)
        return 0
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
