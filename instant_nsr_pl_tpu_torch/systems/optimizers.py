"""Optimizer + learning-rate schedules on ``torch.optim``.

Port of ``instant_nsr_pl_tpu/systems/optimizers.py`` (reference:
systems/utils.py:12-346). Schedules are multiplicative *factor schedules* of
a group's base lr, functions of the number of updates already done (optax's
count), evaluated on the host before each update; the per-submodule groups
(``optimizer.params.<key>.lr``) are one ``torch.optim`` parameter group per
top-level key of the parameter tree, in sorted key order, each group's
tensors in the JAX package's leaf order (sorted dict keys, lists in order),
so optimizer states carry across leaf by leaf.

AdamW's ``weight_decay`` defaults to 0.01, as in torch and the JAX package
(not optax's 1e-4).
"""

from __future__ import annotations

import math

import torch

from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves


# ---------------------------------------------------------------------------
# factor schedules: step -> multiplicative lr factor
# ---------------------------------------------------------------------------


def _constant_factor(cfg):
    factor = float(cfg.get("factor", 1.0 / 3.0))
    total = int(cfg.get("total_iters", 5))
    return lambda step: factor if step < total else 1.0


def _linear_factor(cfg):
    start = float(cfg.get("start_factor", 1.0 / 3.0))
    end = float(cfg.get("end_factor", 1.0))
    total = int(cfg.get("total_iters", 5))

    def sched(step):
        t = min(max(step / max(total, 1), 0.0), 1.0)
        return start + (end - start) * t

    return sched


def _exponential_factor(cfg):
    gamma = float(cfg["gamma"])
    return lambda step: gamma**step


def _multistep_factor(cfg):
    milestones = tuple(int(m) for m in cfg["milestones"])
    gamma = float(cfg.get("gamma", 0.1))
    return lambda step: gamma ** sum(step >= m for m in milestones)


def _step_factor(cfg):
    step_size = int(cfg["step_size"])
    gamma = float(cfg.get("gamma", 0.1))
    return lambda step: gamma ** math.floor(step / step_size)


def _cosine_factor(cfg):
    t_max = int(cfg["T_max"])
    eta_min = float(cfg.get("eta_min", 0.0))

    def sched(step):
        t = min(max(step / max(t_max, 1), 0.0), 1.0)
        # eta_min is a factor of the base lr here (torch's is absolute;
        # configs pass 0), as in the JAX package
        return eta_min + (1.0 - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t))

    return sched


def _sequential_factor(cfg):
    """torch SequentialLR: switch schedulers at milestones, each child seeing
    a step counter restarted at its activation."""
    children = [make_factor_schedule(c) for c in cfg["schedulers"]]
    milestones = [int(m) for m in cfg["milestones"]]
    if len(milestones) != len(children) - 1:
        raise ValueError("SequentialLR needs one milestone fewer than schedulers")
    bounds = [0] + milestones

    def sched(step):
        out = children[0](step)
        for i in range(1, len(children)):
            if step >= bounds[i]:
                out = children[i](step - bounds[i])
        return out

    return sched


def _chained_factor(cfg):
    """torch ChainedScheduler: all children step every step; factors multiply."""
    children = [make_factor_schedule(c) for c in cfg["schedulers"]]
    return lambda step: math.prod(c(step) for c in children)


_FACTORY = {
    "ConstantLR": _constant_factor,
    "LinearLR": _linear_factor,
    "ExponentialLR": _exponential_factor,
    "MultiStepLR": _multistep_factor,
    "StepLR": _step_factor,
    "CosineAnnealingLR": _cosine_factor,
    "SequentialLR": _sequential_factor,
    "ChainedScheduler": _chained_factor,
}


def make_factor_schedule(cfg, epoch_steps=None):
    """Scheduler config ``{name, interval, args: {...}, [schedulers],
    [milestones]}`` -> fn(step) -> multiplicative factor (a Python float).
    ``interval: epoch`` evaluates the schedule on ``floor(step /
    epoch_steps)``, one nominal epoch being one pass over the train split's
    images."""
    if cfg is None:
        return lambda step: 1.0
    name = cfg["name"]
    if name not in _FACTORY:
        raise ValueError(f"Unknown scheduler '{name}'. Known: {sorted(_FACTORY)}")
    interval = cfg.get("interval", "step")
    if interval not in ("step", "epoch"):
        raise ValueError(f"scheduler interval must be step|epoch, got {interval}")
    args = dict(cfg.get("args", {}).items()) if "args" in cfg else {}
    # children inherit the parent's interval translation
    if "schedulers" in cfg:
        args["schedulers"] = [
            dict(c, interval="step") if hasattr(c, "keys") else c for c in cfg["schedulers"]
        ]
    if "milestones" in cfg and "milestones" not in args:
        args["milestones"] = list(cfg["milestones"])
    sched = _FACTORY[name](args)
    if interval == "epoch":
        if not epoch_steps:
            raise ValueError(
                "scheduler interval: epoch needs a dataset length to translate "
                "epochs->steps (build the system with setup_data before init_state)"
            )
        base = sched
        sched = lambda step: base(math.floor(step / epoch_steps))  # noqa: E731
    return sched


# ---------------------------------------------------------------------------
# parameter groups and the optimizer
# ---------------------------------------------------------------------------


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with one parameter group per top-level key
    of the parameter tree and a factor schedule: before update ``count``
    (the number of updates already done) every group's lr is set to its
    base lr times ``factor(count)``, as optax's schedules are evaluated."""

    def __init__(self, optimizer, factor, base_lr):
        self.optimizer = optimizer
        self.factor = factor
        self.base_lr = base_lr

    def lr(self, count):
        """The base group's lr of update ``count`` (for logging)."""
        return self.base_lr * self.factor(count)

    def step(self, count):
        f = self.factor(count)
        for group in self.optimizer.param_groups:
            group["lr"] = group["group_lr"] * f
        self.optimizer.step()

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, sd):
        self.optimizer.load_state_dict(sd)


def _torch_optimizer(name, groups, args):
    betas = args.get("betas", (0.9, 0.999))
    betas = (float(betas[0]), float(betas[1]))
    eps = float(args.get("eps", 1e-8))
    if name in ("Adam", "FusedAdam"):
        return torch.optim.Adam(groups, betas=betas, eps=eps)
    if name == "AdamW":
        wd = float(args.get("weight_decay", 0.01))
        return torch.optim.AdamW(groups, betas=betas, eps=eps, weight_decay=wd)
    if name == "SGD":
        return torch.optim.SGD(groups, lr=groups[0]["lr"],
                               momentum=float(args.get("momentum", 0.0)))
    raise ValueError(f"Unknown optimizer '{name}'")


def make_optimizer(optimizer_cfg, scheduler_cfg, params, epoch_steps=None):
    """Build the optimizer of a config over the parameter tree ``params``
    (its leaves are the tensors to train).

    ``optimizer.args`` are the base hyperparameters; ``optimizer.params.<key>``
    overrides a top-level key's lr; the scheduler's factor multiplies every
    group's lr. Returns ``(ScheduledOptimizer, lr_fn)``, lr_fn(step) the base
    group's lr."""
    name = optimizer_cfg["name"]
    args = dict(optimizer_cfg.get("args", {}).items())
    base_lr = float(args.get("lr", 1e-3))
    factor = make_factor_schedule(scheduler_cfg, epoch_steps=epoch_steps)
    group_cfg = optimizer_cfg.get("params", None)
    groups = []
    for key in sorted(params):
        glr = base_lr
        if group_cfg is not None and key in group_cfg:
            glr = float(group_cfg[key].get("lr", base_lr))
        tensors = [t for _, t in named_leaves(params[key])]
        if tensors:
            groups.append({"params": tensors, "lr": glr, "group_lr": glr, "name": key})
    opt = ScheduledOptimizer(_torch_optimizer(name, groups, args), factor, base_lr)
    return opt, opt.lr
