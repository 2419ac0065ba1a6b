"""Data-parallel runs for checking the plan: ranks spawned on this host, the
plan driven on given batches, and an observer of a launcher run's ranks.

- :func:`spawn` runs ``fn(group, device, *args)`` on N ranks (spawned
  processes joined through a ``file://`` rendezvous in a fresh temporary
  directory, so concurrent callers cannot collide) and returns each rank's
  result; a rank's failure or the timeout raises, and every rank process is
  stopped.
- :func:`train_run`, :func:`grid_updates` and :func:`step_on_batches` are
  rank functions for it: a short training run (or ``train_chunk`` runs),
  the single and the collective occupancy update from the same draws, and
  one plan step from each rank's given batch with the reduced gradients.
- :func:`observe` is a launcher ``rank_hook`` (``launch.main(argv,
  rank_hook=functools.partial(observe, ...))``): around the system's own
  ``train_step`` it records on every rank each step's kernel launches and
  the digest of the rank's batch, the state's digests after the first grid
  update and at the end, the warm step wall and the gradient reduction's
  CUDA-event time, and at one step holds the plan's step against rank 0's
  single-rank emulation (the mean of every rank's gradients on its own
  batch, then the optimizer); rank 0 gathers the ranks' records into one
  JSON file.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import tempfile
import time

import torch

# the launch counters an observed run reads, by module and wrapper
COUNTERS = {
    "hashgrid_forward": ("hashgrid", "hashgrid_forward"),
    "hashgrid_backward": ("hashgrid", "hashgrid_backward"),
    "hashgrid_lattice_forward": ("hashgrid", "hashgrid_lattice_forward"),
    "hashgrid_lattice_backward": ("hashgrid", "hashgrid_lattice_backward"),
    "sh_mlp_forward": ("sh_mlp", "sh_mlp_forward"),
    "sh_mlp_backward": ("sh_mlp", "sh_mlp_backward"),
    "marching_classify": ("isosurface", "marching_classify"),
    "marching_emit": ("isosurface", "marching_emit"),
}


def _counters():
    import importlib

    return {k: getattr(importlib.import_module(f"instant_nsr_pl_tpu_torch.ops.{m}"), f)
            for k, (m, f) in COUNTERS.items()}


# ---------------------------------------------------------------------------
# ranks on this host
# ---------------------------------------------------------------------------


def _rank_entry(rank, n, init, backend, device, out_dir, threads):
    import torch.distributed as dist

    from instant_nsr_pl_tpu_torch.parallel.distributed import (
        Group,
        maybe_initialize_distributed,
        rank_device,
    )

    if threads:
        torch.set_num_threads(threads)
    fn, args = torch.load(os.path.join(out_dir, "job.pt"), weights_only=False)
    maybe_initialize_distributed(init, n, rank, backend=backend, device=device)
    try:
        dev = rank_device(device, rank)
        result = fn(Group(dev), dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by :func:`start`; :meth:`result` waits for them."""

    def __init__(self, ctx, tmp, n, name, timeout):
        self.ctx, self.tmp, self.n, self.name = ctx, tmp, n, name
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def result(self):
        """The ranks' results in rank order. Raises ``TimeoutError`` past
        the timeout, or a rank's exception; every rank process is stopped
        and the rendezvous directory removed either way."""
        try:
            try:
                while not self.ctx.join(timeout=max(self.deadline - time.monotonic(), 0.01)):
                    if time.monotonic() >= self.deadline:
                        raise TimeoutError(f"{self.n} ranks of {self.name} ran over "
                                           f"{self.timeout} s")
            finally:
                for p in self.ctx.processes:
                    if p.is_alive():
                        p.terminate()
                    p.join()
            return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(self.n)]
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def start(fn, n, *args, backend=None, device="cpu", timeout=300.0, threads=1):
    """Start ``fn(group, device, *args)`` on ``n`` spawned ranks (``fn``
    importable, ``args`` picklable; ``threads`` torch threads a rank, None
    to keep the default) and return their :class:`Ranks` at once."""
    import torch.multiprocessing as mp

    from instant_nsr_pl_tpu_torch.parallel.distributed import default_backend

    tmp = tempfile.mkdtemp(prefix="nsr_dp_")
    # the job goes through a file: a spawned child reads its arguments from
    # the pipe only after its imports, and the parent's write waits for that
    torch.save((fn, args), os.path.join(tmp, "job.pt"))
    ctx = mp.start_processes(
        _rank_entry, args=(n, f"file://{os.path.join(tmp, 'store')}",
                           backend or default_backend(device), device, tmp, threads),
        nprocs=n, join=False, start_method="spawn")
    return Ranks(ctx, tmp, n, fn.__name__, timeout)


def spawn(fn, n, *args, **kwargs):
    """:func:`start`, then wait for the results."""
    return start(fn, n, *args, **kwargs).result()


def run_all(group, device, jobs):
    """Rank function running several rank functions of this module in turn
    on the same ranks: ``jobs`` is a list of (label, function name, args);
    returns {label: result} and, under ``"seconds"``, each job's wall time."""
    out, seconds = {}, {}
    for label, name, args in jobs:
        t0 = time.perf_counter()
        out[label] = globals()[name](group, device, *args)
        seconds[label] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def build_system(cfg, device, group=None):
    """The system of config dict ``cfg`` on its train split, with the plan
    over ``group`` when one is given."""
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)

    config = config_from_dict(cfg)
    dm = datasets.make(config.dataset.name, config.dataset)
    dm.setup("fit")
    system = systems.make(config.system.name, config, device=device)
    system.setup_data(dm.train)
    if group is not None:
        system.configure_parallel(group)
    return system


def batch_digest(batch) -> str:
    """sha256 of a training batch's ray directions (16 hex digits)."""
    rays = batch["rays_d"].detach().contiguous().cpu().numpy()
    return hashlib.sha256(rays.tobytes()).hexdigest()[:16]


def watch_draws(plan, on_draw=None):
    """Observe the plan's own batch draws: ``plan.rank_batch`` is wrapped so
    that each draw appends :func:`batch_digest` of the batch to the list
    returned, then calls ``on_draw(state, seed)``. Returns (that list, the
    unwrapped ``rank_batch``)."""
    draw, seen = plan.rank_batch, []

    def rank_batch(state, seed, rank):
        batch, gen = draw(state, seed, rank)
        seen.append(batch_digest(batch))
        if on_draw is not None:
            on_draw(state, seed)
        return batch, gen

    plan.rank_batch = rank_batch
    return seen, draw


def train_run(group, device, cfg, steps, chunks=None, seed=0, grid_res=None):
    """``steps`` plan steps (or ``train_chunk`` calls of the sizes in
    ``chunks``) from ``init_state(seed)``; returns the losses and training
    PSNRs, the digest of this rank's batch at each step
    (:func:`batch_digest`), the final state's digests and whether the
    geometry's hash encoding kept its tap-dedup spec (and so reads its coarse
    levels from block lattices, HG5 / HG6, when a rank's capacity divides
    the block size). ``grid_res`` shrinks
    the grids (:func:`small_grids`)."""
    from instant_nsr_pl_tpu_torch.parallel.distributed import state_digests

    system = build_system(cfg, device, group)
    if grid_res:
        small_grids(system.model, grid_res)
    batches, _ = watch_draws(system.plan)
    state = system.init_state(seed)
    losses, psnrs = [], []
    for k in (chunks or [1] * steps):
        state, metrics = system.train_chunk(state, k)
        losses.append(float(metrics["train/loss"]))
        psnrs.append(float(metrics["train/psnr"]))
    enc = system.model.geometry.encoding_with_network.encoding
    return {"losses": losses, "psnrs": psnrs, "batches": batches,
            "digests": state_digests(state), "step": int(state["step"]),
            "dedup": getattr(getattr(enc, "encoding", enc), "dedup_spec", None) is not None}


def grid_updates(group, device, cfg, resolution, seed=7):
    """The model's single and collective occupancy updates from the same
    draws (generators seeded with ``seed``) in the warmup, slab and random
    modes, on a ``resolution``^3 grid in place of the model's; the random
    mode on the warmed grid. Returns {mode: (single, collective)}, each
    (occs, binary, binary_dilated) as numpy."""
    system = build_system(cfg, device)
    model = system.model
    small_grids(model, resolution)
    state = system.init_state(0)
    out = {}
    occ = state["occ"]
    for mode, warmup, phase in (("warmup", True, None), ("slab", False, 3),
                                ("random", False, None)):
        pair = []
        for g in (None, group):
            gen = torch.Generator(device=device).manual_seed(seed)
            new = model.update_occupancy(state["params"], occ, gen, warmup=warmup,
                                         phase=phase, step=0, group=g)
            pair.append(tuple(t.cpu().numpy() for t in new["grid"]))
        out[mode] = tuple(pair)
        if mode == "warmup":
            occ = new
    return out


def replicate_check(group, device, cfg):
    """``DataParallelPlan.replicate`` on a state every rank seeded alike
    (before and after digests), then on one whose parameters, optimizer
    moments and generator every rank but 0 moved: returns the three
    digests."""
    from instant_nsr_pl_tpu_torch.parallel.distributed import state_digests
    from instant_nsr_pl_tpu_torch.utils.transplant import state_dict

    system = build_system(cfg, device)
    state = system.init_state(0)  # no plan yet: nothing broadcast
    seeded = state_digests(state)
    plan = system.configure_parallel(group)
    alike = state_digests(plan.replicate(state))
    state, _ = system.train_step(state)
    if group.rank:
        with torch.no_grad():
            for t in state_dict(state["params"]).values():
                t.add_(group.rank)
            for s in state["optimizer"].optimizer.state.values():
                s["exp_avg"].add_(group.rank)
        state["generator"].manual_seed(group.rank)
    moved = state_digests(state)
    return {"seeded": seeded, "alike": alike, "moved": moved,
            "replicated": state_digests(plan.replicate(state))}


def render_views(group, device, cfg, steps, grid_res=None):
    """One val view rendered by the plan (the chunk's rays sharded over the
    ranks and gathered) and by a system of the same config without it,
    after ``steps`` plan steps; returns both images, both render stats and
    the steps' losses."""
    system = build_system(cfg, device, group)
    if grid_res:
        small_grids(system.model, grid_res)
    state = system.init_state(0)
    losses = []
    for _ in range(steps):
        state, metrics = system.train_step(state)
        losses.append(float(metrics["train/loss"]))
    sharded = system.render_image(state, 0)
    alone = build_system(cfg, device)
    if grid_res:
        small_grids(alone.model, grid_res)
    single = alone.render_image(state, 0)
    return {"sharded": sharded, "single": single, "stats": system.last_render_stats,
            "single_stats": alone.last_render_stats, "losses": losses}


def step_on_batches(group, device, cfg, params, grid, batches):
    """One plan step from given inputs: ``params`` (the port's flat names
    -> numpy), ``grid`` (occs, binary, binary_dilated numpy) and rank r's
    batch ``batches[r]`` (numpy; the config should turn the stratified
    jitter off, as nothing else draws from the generator). Returns the
    reduced metrics, the averaged gradients and the updated parameters."""
    from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState
    from instant_nsr_pl_tpu_torch.utils.transplant import state_dict

    system = build_system(cfg, device, group)
    state = system.init_state(0)
    live = state_dict(state["params"])
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(torch.as_tensor(params[k]))
    state["occ"] = {"grid": OccupancyGridState(*(torch.as_tensor(a, device=device)
                                                 for a in grid))}
    batch = {k: torch.as_tensor(v, device=device) for k, v in batches[group.rank].items()}
    state, metrics = system.plan.step_on_batch(state, batch, None)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: t.grad.cpu().numpy() for k, t in live.items()},
            "params": {k: t.detach().cpu().numpy() for k, t in live.items()}}


def small_grids(model, resolution):
    """The model's occupancy grids (NeuS's background one too) at
    ``resolution``^3 in place of their 128^3 / 256^3, so a CPU run's grid
    updates take a moment."""
    import dataclasses

    for attr in ("occ_spec", "occ_spec_bg"):
        if hasattr(model, attr):
            setattr(model, attr, dataclasses.replace(getattr(model, attr),
                                                     resolution=resolution))
    model.occupancy_grid_res = resolution


def checkpoint_roundtrip(group, device, config_path, overrides, ckpt_dir, steps=2,
                         grid_res=None):
    """The checkpoint contract over the ranks: ``steps`` plan steps,
    ``Trainer.save`` (rank 0 writes after the replica check, every rank
    waits), ``steps`` more (the uninterrupted arm); then every rank restores
    rank 0's file into a fresh state and runs the same ``steps``. Returns
    both arms' losses and digests and whether the state holds a background
    grid. ``grid_res`` shrinks the grids (:func:`small_grids`)."""
    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.parallel.distributed import state_digests
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.trainer import Trainer
    from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)

    config = load_config(config_path, cli_args=list(overrides))
    dm = datasets.make(config.dataset.name, config.dataset)
    dm.setup("fit")
    system = systems.make(config.system.name, config, device=device)
    if grid_res:
        small_grids(system.model, grid_res)
    system.setup_data(dm.train)
    system.configure_parallel(group)
    seed = int(config.get("seed", 42))
    state = system.init_state(seed)

    def run(st):
        losses = []
        for _ in range(steps):
            st, metrics = system.train_step(st)
            losses.append(float(metrics["train/loss"]))
        return st, losses

    state, _ = run(state)
    path = Trainer(config, ckpt_dir, loggers=[]).save(state, steps, system)
    path = group.broadcast_object(path)
    state, losses_cont = run(state)
    restored = system.replicate(load_checkpoint(path, system.init_state(seed)))
    restored, losses_res = run(restored)
    return {"losses_cont": losses_cont, "losses_res": losses_res,
            "cont": state_digests(state), "res": state_digests(restored),
            "has_bg": "grid_bg" in restored["occ"]}


# ---------------------------------------------------------------------------
# observing a launcher run's ranks
# ---------------------------------------------------------------------------


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def emulate_step(plan, state, seed, draw=None):
    """Rank 0's single-rank emulation of the plan's step of ``seed``: on a
    copy of the parameters and the optimizer, every rank's batch (rebuilt
    from the seed by ``draw``, default ``plan.rank_batch``) through
    ``loss_fn`` at ``capacity_per_dev``, the mean of the gradients, then the
    optimizer. Returns (mean gradients, updated parameters) by flat name
    and the rebuilt batches' :func:`batch_digest` in rank order."""
    from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable
    from instant_nsr_pl_tpu_torch.systems.optimizers import make_optimizer
    from instant_nsr_pl_tpu_torch.utils.transplant import state_dict

    system = plan.system
    step = state["step"]
    params = make_trainable(_clone(state["params"]))
    optimizer, _ = make_optimizer(system.config.system.optimizer,
                                  system.config.system.get("scheduler", None), params,
                                  epoch_steps=system.steps_per_epoch)
    # a deep copy: load_state_dict keeps tensors already on the right device
    # and dtype, which would share the moments with the live optimizer
    optimizer.load_state_dict(copy.deepcopy(state["optimizer"].state_dict()))
    named = state_dict(params)
    total = {k: torch.zeros_like(t) for k, t in named.items()}
    digests = []
    for r in range(plan.n_dev):
        batch, gen = (draw or plan.rank_batch)(state, seed, r)
        digests.append(batch_digest(batch))
        optimizer.zero_grad()
        loss, _ = system.loss_fn(params, state["occ"], batch, gen, step,
                                 n_rays=batch["rays_o"].shape[0],
                                 capacity=plan.capacity_per_dev, extra=state.get("extra"))
        loss.backward()
        for k, t in named.items():
            if t.grad is not None:
                total[k] += t.grad
    for k, t in named.items():
        t.grad = total[k] / plan.n_dev
    optimizer.step(step)
    return ({k: t.grad.detach().clone() for k, t in named.items()},
            {k: t.detach().clone() for k, t in named.items()}, digests)


def _held(tag, got, ref, rel):
    """max |got - ref| over max |ref| per tensor; raises above ``rel``."""
    worst = 0.0
    for k in ref:
        scale = float(ref[k].abs().max())
        err = float((got[k] - ref[k]).abs().max())
        share = err / scale if scale > 0 else err
        if share > rel:
            raise AssertionError(f"{tag} {k}: max |DP - emulation| {err:.3e} is {share:.3e} "
                                 f"of max |emulation| {scale:.3e} (limit {rel})")
        worst = max(worst, share)
    return worst


def observe(system, trainer, *, out, emulate_at, warm_from, rel=2.5e-2):
    """A launcher ``rank_hook``. Wraps the system's own ``train_step`` (the
    plan's step runs unchanged) to record on every rank each step's
    launches of :data:`COUNTERS`, its loss, the digest of the rank's batch
    (:func:`watch_draws`) and the state's digests after step 0 (the first
    grid update), and to time the steps from ``warm_from`` to the trainer's
    last (host clock, the card's queue drained at both ends) with CUDA
    events around each gradient reduction. At step ``emulate_at`` rank 0,
    once the plan has drawn its batch, runs :func:`emulate_step` on the
    state the step starts from; after the step the averaged gradients and
    the parameters' updates must lie within ``rel`` of the emulation's
    largest per tensor, and the emulation's launches are left out of every
    count. Wraps ``trainer.fit`` to add the final digests and the
    training's launches, and ``trainer.test`` to add the whole run's
    launches (rank 0 exports the mesh there) and gather every rank's record
    into ``out`` (JSON, on rank 0)."""
    from instant_nsr_pl_tpu_torch.parallel.distributed import state_digests
    from instant_nsr_pl_tpu_torch.utils.transplant import state_dict

    plan = system.plan
    counters = _counters()
    start = {k: c.launches for k, c in counters.items()}
    cuda = system.device.type == "cuda"
    plan.timing = [] if cuda else None
    rec = {"rank": plan.rank, "world": plan.n_dev, "backend": plan.group.backend,
           "device": str(system.device), "steps": [], "emulation": None}
    marks, pending = {}, {}
    excluded = {k: 0 for k in counters}

    def emulate(state, seed):
        if int(state["step"]) != emulate_at or plan.rank != 0:
            return
        mark = {k: c.launches for k, c in counters.items()}
        pending["params0"] = {k: v.detach().clone()
                              for k, v in state_dict(state["params"]).items()}
        pending["ref"] = emulate_step(plan, state, seed, draw)
        pending["extra"] = {k: c.launches - mark[k] for k, c in counters.items()}

    batches, draw = watch_draws(plan, emulate)
    step_of = system.train_step

    def sync():
        if cuda:
            torch.cuda.synchronize(system.device)

    def launched_since(mark):
        return {k: c.launches - mark[k] - excluded[k] for k, c in counters.items()}

    def train_step(state):
        step = int(state["step"])
        if step == warm_from:
            sync()
            marks["t0"], marks["reduce0"] = time.perf_counter(), len(plan.timing or [])
        before = {k: c.launches - excluded[k] for k, c in counters.items()}
        pending.clear()
        drawn = len(batches)
        state, metrics = step_of(state)
        assert len(batches) == drawn + 1, "the step drew no batch through the plan"
        for k, v in pending.get("extra", {}).items():
            excluded[k] += v
        rec["steps"].append({"step": step, "rays": system.active_num_rays,
                             "loss": float(metrics["train/loss"]), "batch": batches[-1],
                             "launches": launched_since(before)})
        if "ref" in pending:
            ref_grads, ref_params, ref_batches = pending["ref"]
            params0 = pending["params0"]
            live = state_dict(state["params"])
            grads = {k: t.grad for k, t in live.items()}
            rec["emulation"] = {
                "step": step, "rel": rel, "batches": ref_batches,
                "grad_share": _held("mean gradient", grads, ref_grads, rel),
                "update_share": _held(
                    "parameter update", {k: live[k].detach() - params0[k] for k in live},
                    {k: ref_params[k] - params0[k] for k in live}, rel),
                "launches_excluded": pending["extra"]}
        if step == 0:
            rec["digests_first_update"] = state_digests(state)
        if step == trainer.max_steps - 1:  # the window ends before the val / checkpoint
            sync()
            marks["t1"], marks["reduce1"] = time.perf_counter(), len(plan.timing or [])
        return state, metrics

    fit, test = trainer.fit, trainer.test

    def fit_and_record(*args, **kwargs):
        state = fit(*args, **kwargs)
        if "t0" in marks and "t1" in marks:
            n = trainer.max_steps - warm_from
            events = plan.timing[marks["reduce0"]:marks["reduce1"]] if plan.timing else []
            reduce_ms = sum(s.elapsed_time(e) for s, e in events)
            wall_ms = (marks["t1"] - marks["t0"]) * 1e3
            rec["warm"] = {"steps": n, "ms_per_step": wall_ms / n,
                           "reduce_ms_per_step": reduce_ms / n if cuda else None,
                           "reduce_share": reduce_ms / wall_ms if cuda else None}
        rec["digests_end"] = state_digests(state)
        rec["launches_fit"] = launched_since(start)
        return state

    def test_and_report(*args, **kwargs):
        psnr = test(*args, **kwargs)
        rec["launches_run"] = launched_since(start)
        records = plan.group.all_gather_object(rec)
        if plan.rank == 0:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as fh:
                json.dump(records, fh, indent=1)
        return psnr

    system.train_step = train_step
    trainer.fit = fit_and_record
    trainer.test = test_and_report


def read_report(path):
    """The ranks' records :func:`observe` wrote."""
    with open(path) as fh:
        return json.load(fh)


def agree(records, key):
    """True if every rank's ``key`` digests equal rank 0's."""
    return all(r[key] == records[0][key] for r in records)


def launches_each_step(records, names):
    """The (rank, step, name) of every step that did not launch a kernel
    of ``names``."""
    return [(r["rank"], s["step"], k) for r in records for s in r["steps"] for k in names
            if s["launches"][k] < 1]


def same_batches(records):
    """The steps at which two ranks drew equal batches (a plan whose ranks
    all train on one shard would show every step)."""
    by_step = {}
    for r in records:
        for s in r["steps"]:
            by_step.setdefault(s["step"], []).append(s["batch"])
    return sorted(k for k, v in by_step.items() if len(set(v)) < len(v))


def emulation_batches_match(records):
    """True if rank 0's emulation rebuilt, for every rank, the batch that
    rank drew at that step."""
    emu = records[0]["emulation"]
    drawn = [next(s["batch"] for s in r["steps"] if s["step"] == emu["step"])
             for r in sorted(records, key=lambda r: r["rank"])]
    return emu["batches"] == drawn
