"""Data-parallel training over ranks of a process group (the reference's DDP
role).

Port of ``instant_nsr_pl_tpu/parallel/data_parallel.py`` (``DataParallelPlan``
:34-183). The JAX package shards one jitted step over a device mesh and
``pmean``s the gradients inside it; here every rank is a process with its
own card, and the plan is eager:

- the state's generator stays replicated (the same seed on every rank, the
  same draws); each step it gives one seed, from which each rank builds its
  own sampling generator (the JAX ``split(k, n_dev)``), so a checkpoint still
  holds one generator;
- each rank samples ``rays_per_dev`` rays (its share of the active ray
  bucket) and runs ``loss_fn`` at ``capacity_per_dev`` packed samples, then
  backward;
- the gradients are averaged by an explicit ``all_reduce`` (sum, then divided
  by the world size: gloo has no average) over the flattened gradients in
  buckets. The parameters are a tree of leaf tensors, not an ``nn.Module``,
  so no ``DistributedDataParallel`` wrapper: the reduction after
  ``loss.backward()`` is the counterpart of ``pmean`` after
  ``value_and_grad``, and a parameter without a gradient reduces as zeros;
- metrics: ``*num_samples`` summed, the rest averaged;
- the optimizer step and ``update_extra_state`` run identically on every
  rank, so the parameters stay equal to the bit;
- the occupancy update is collective: the jittered cell positions come from
  the replicated generator, each rank evaluates a contiguous shard of them,
  and ``all_gather`` gives every rank all the values (``Group.sharded_eval``),
  so every rank applies the identical EMA, threshold and dilation (JAX
  ``ops/marching.py:380-402``).
"""

from __future__ import annotations

import hashlib

import torch

# bytes of gradient per all_reduce (DistributedDataParallel's bucket_cap_mb)
BUCKET_BYTES = 25 << 20


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s sampling generator in the step of
    ``seed``."""
    digest = hashlib.sha256(f"{seed}:{rank}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def step_seed(generator) -> int:
    """One seed drawn from the replicated ``generator``: read from its state
    on the host (no wait for the device), which then moves on by one draw.
    Ranks whose generators agree get the same seed."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()).digest()
    torch.empty(1, device=generator.device).uniform_(generator=generator)
    return int.from_bytes(digest[:8], "little") >> 1


class DataParallelPlan:
    """Training and grid updates of ``system`` over the ranks of ``group``
    (a :class:`~instant_nsr_pl_tpu_torch.parallel.distributed.Group`).
    Every ray bucket and the train capacity must divide by the world size.
    With ``timing`` a list, each step appends the (start, end) CUDA events
    around its gradient reduction."""

    def __init__(self, system, group):
        self.system = system
        self.group = group
        self.n_dev = int(group.size)
        self.rank = int(group.rank)
        for b in system.ray_buckets:
            if b % self.n_dev:
                raise ValueError(f"ray bucket {b} must divide by the world size {self.n_dev}")
        if system.train_capacity % self.n_dev:
            raise ValueError(f"train capacity {system.train_capacity} must divide by the "
                             f"world size {self.n_dev}")
        self.capacity_per_dev = system.train_capacity // self.n_dev
        self.timing = None

    @property
    def rays_per_dev(self) -> int:
        """Each rank's rays in a step: its share of the active bucket (the
        JAX plan's ``n_rays // n_dev``)."""
        return self.system.active_num_rays // self.n_dev

    # -- state --------------------------------------------------------------
    def replicate(self, state):
        """Rank 0's parameters, optimizer state, grids, extra state and
        generator on every rank (what DDP broadcasts when it is built);
        ranks seeded alike already hold them."""
        g = self.group
        with torch.no_grad():
            opt = state["optimizer"].optimizer
            for group in opt.param_groups:
                for p in group["params"]:
                    g.broadcast_(p.data)
                    for v in opt.state.get(p, {}).values():
                        if torch.is_tensor(v):
                            g.broadcast_(v)
            for grid in state["occ"].values():
                for t in grid:
                    g.broadcast_(t)
            for t in state.get("extra", {}).values():
                g.broadcast_(t)
        gen_state = g.broadcast_(state["generator"].get_state())
        state["generator"].set_state(gen_state)
        return state

    # -- train --------------------------------------------------------------
    def rank_batch(self, state, seed: int, rank: int):
        """Rank ``rank``'s batch of the step of ``seed`` and its generator
        (which the forward goes on drawing from): ``rays_per_dev`` rays."""
        system = self.system
        gen = torch.Generator(device=system.device).manual_seed(rank_seed(seed, rank))
        return system.draw_batch(gen, self.rays_per_dev), gen

    def local_gradients(self, state, batch, generator):
        """This rank's loss on ``batch`` at ``capacity_per_dev`` and its
        gradients (in the parameters' ``.grad``); returns (loss, metrics)."""
        optimizer = state["optimizer"]
        optimizer.zero_grad()
        loss, metrics = self.system.loss_fn(
            state["params"], state["occ"], batch, generator, state["step"],
            n_rays=batch["rays_o"].shape[0], capacity=self.capacity_per_dev,
            extra=state.get("extra"))
        loss.backward()
        return loss, metrics

    def _params(self, state):
        return [p for group in state["optimizer"].optimizer.param_groups
                for p in group["params"]]

    def reduce_gradients(self, state):
        """Average every parameter's gradient over the ranks: flattened in
        buckets of ``BUCKET_BYTES``, summed by ``all_reduce``, divided by the
        world size. A parameter without a gradient counts as zeros."""
        params = self._params(state)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        bucket, size = [], 0
        for p in params + [None]:
            if p is not None:
                bucket.append(p.grad)
                size += p.grad.numel() * p.grad.element_size()
            if bucket and (p is None or size >= BUCKET_BYTES):
                flat = torch.cat([t.reshape(-1) for t in bucket])
                self.group.all_reduce_sum_(flat)
                flat /= self.n_dev
                for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                    t.copy_(v.view_as(t))
                bucket, size = [], 0

    def reduce_metrics(self, loss, metrics):
        """The step's metrics over the ranks: ``*num_samples`` summed, the
        rest (and the loss, as ``train/loss``) averaged; one all_reduce."""
        keys = sorted(metrics)
        dev = loss.device
        vals = torch.stack([loss.detach().double()] + [
            torch.as_tensor(metrics[k], device=dev).detach().double().reshape(())
            for k in keys])
        self.group.all_reduce_sum_(vals)
        out = {}
        for k, v in zip(keys, vals[1:]):
            out[k] = v if k.endswith("num_samples") else v / self.n_dev
        out["train/loss"] = vals[0] / self.n_dev
        return out

    def step_on_batch(self, state, batch, generator):
        """The step from this rank's ``batch``: local gradients, their
        average over the ranks, the optimizer update and the extra state,
        identical on every rank. Returns (state, metrics)."""
        system = self.system
        step = state["step"]
        loss, metrics = self.local_gradients(state, batch, generator)
        if self.timing is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        self.reduce_gradients(state)
        if self.timing is not None:
            end.record()
            self.timing.append((start, end))
        metrics = self.reduce_metrics(loss, metrics)
        optimizer = state["optimizer"]
        optimizer.step(step)
        update_extra = getattr(system.model, "update_extra_state", None)
        if update_extra is not None:
            state["extra"] = update_extra(state["params"], state.get("extra", {}), step)
        metrics["train/lr"] = optimizer.lr(step)
        state["step"] = step + 1
        return state, metrics

    def begin_step(self, state):
        """The grid update when the step asks for one, then the step's seed
        (both from the replicated generator)."""
        system = self.system
        step = state["step"]
        if step % system.grid_update_every == 0:
            self.update_occupancy(state, warmup=step < system.grid_warmup_steps)
        return step_seed(state["generator"])

    def train_step(self, state):
        """One data-parallel step (``BaseSystem.train_step`` under the plan)."""
        seed = self.begin_step(state)
        batch, gen = self.rank_batch(state, seed, self.rank)
        return self.step_on_batch(state, batch, gen)

    # -- collective occupancy update ----------------------------------------
    def update_occupancy(self, state, warmup: bool):
        """``BaseSystem.update_occupancy`` with the cell evaluations sharded
        over the ranks and gathered back."""
        system = self.system
        phase = None
        if not warmup and system.grid_update_sampling == "slab":
            phase = (state["step"] // system.grid_update_every) % 8
        state["occ"] = system.model.update_occupancy(
            state["params"], state["occ"], state["generator"], warmup=warmup, phase=phase,
            step=state["step"], group=self.group)
        return state

    # -- checks ---------------------------------------------------------------
    def check_replicas(self, state):
        """Every rank's :func:`state_digests` gathered; raises if any rank's
        differs from rank 0's. Returns rank 0's."""
        from instant_nsr_pl_tpu_torch.parallel.distributed import state_digests

        all_digests = self.group.all_gather_object(state_digests(state))
        for r, d in enumerate(all_digests[1:], start=1):
            if d != all_digests[0]:
                bad = sorted(k for k in d if d[k] != all_digests[0][k])
                raise RuntimeError(f"rank {r}'s train state differs from rank 0's in {bad} "
                                   f"at step {all_digests[0]['step']}")
        return all_digests[0]

