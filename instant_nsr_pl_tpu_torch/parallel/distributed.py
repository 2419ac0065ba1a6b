"""Multi-process runtime wiring: the process group of a data-parallel run.

Port of ``instant_nsr_pl_tpu/parallel/distributed.py``. The JAX package
runs one process per host, each holding many chips, joined by
``jax.distributed.initialize``; PyTorch runs one process per card (a
*rank*), joined by ``torch.distributed.init_process_group``. Rank discovery
keeps the JAX contract: explicit arguments win, then the ``NSR_COORDINATOR``
/ ``NSR_NUM_PROCESSES`` / ``NSR_PROCESS_ID`` / ``NSR_LOCAL_DEVICE_IDS``
environment variables; without either a run is single-process.

:class:`Group` holds the collectives the data-parallel plan uses. The
backend is NCCL for CUDA ranks and gloo for CPU ranks unless the caller
names one; gloo also runs CUDA ranks (several ranks sharing one card, which
NCCL refuses).
"""

from __future__ import annotations

import hashlib
import os

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_method_of(coordinator: str) -> str:
    """A ``host:port`` coordinator as a TCP rendezvous; a URL
    (``tcp://``, ``file://``) as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def maybe_initialize_distributed(coordinator=None, num_processes=None, process_id=None,
                                 backend=None, device=None, local_device_ids=None) -> bool:
    """Join the process group of a multi-process run when one is asked for
    (arguments, else the ``NSR_*`` variables); returns True if it did.
    ``backend`` defaults to :func:`default_backend` of ``device`` (CUDA
    unless named); a failing backend raises, none other is tried.
    Single-process runs (nothing asked) are a no-op returning False;
    partial arguments raise."""
    coordinator = coordinator or os.environ.get("NSR_COORDINATOR")
    if num_processes is None and "NSR_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NSR_NUM_PROCESSES"])
    if process_id is None and "NSR_PROCESS_ID" in os.environ:
        process_id = int(os.environ["NSR_PROCESS_ID"])
    if coordinator is None and num_processes is None and process_id is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("multi-process launch needs coordinator + num_processes + process_id "
                         "(flags or NSR_* env vars)")
    dev = rank_device(device, process_id, local_device_ids)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=init_method_of(coordinator),
                            world_size=int(num_processes), rank=int(process_id))
    return True


def rank_device(device, rank: int, local_device_ids=None) -> torch.device:
    """The device of rank ``rank``: for CUDA the first of
    ``local_device_ids`` (default ``NSR_LOCAL_DEVICE_IDS``) or card ``rank``
    modulo the visible cards (several ranks on one card only over gloo, see
    the launcher), made current; the CPU as it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if local_device_ids is None and "NSR_LOCAL_DEVICE_IDS" in os.environ:
        local_device_ids = [int(x) for x in os.environ["NSR_LOCAL_DEVICE_IDS"].split(",")]
    if dev.index is None:
        index = (local_device_ids[0] if local_device_ids
                 else rank % max(torch.cuda.device_count(), 1))
        dev = torch.device("cuda", index)
    torch.cuda.set_device(dev)
    return dev


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier():
    """Wait for every rank (no-op single-process)."""
    if dist.is_initialized():
        dist.barrier()


class Group:
    """The default process group and its collectives, on tensors of any
    device. NCCL takes CUDA tensors only: a CPU tensor (a generator's
    state, a host flag) goes through the rank's card. Gloo's all_reduce and
    broadcast take CUDA tensors; its all_gather does not, so
    :meth:`all_gather` alone stages a CUDA tensor through the host there."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("Group needs an initialized process group "
                               "(maybe_initialize_distributed)")
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()

    def _wire(self, t):
        """The tensor the backend takes for ``t`` (``t`` itself if it can)."""
        if self.backend == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def all_reduce_sum_(self, t):
        """Sum ``t`` over the ranks, in place."""
        w = self._wire(t)
        dist.all_reduce(w)
        if w is not t:
            t.copy_(w)
        return t

    def all_reduce_max(self, value: int) -> int:
        """The largest of the ranks' ``value`` (a host int)."""
        w = self._wire(torch.tensor([int(value)], dtype=torch.int64))
        dist.all_reduce(w, op=dist.ReduceOp.MAX)
        return int(w.item())

    def broadcast_(self, t, src: int = 0):
        """Rank ``src``'s ``t`` on every rank, in place (bool as bytes)."""
        view = t.view(torch.uint8) if t.dtype == torch.bool else t
        w = self._wire(view)
        dist.broadcast(w, src)
        if w is not view:
            view.copy_(w)
        return t

    def all_gather(self, t):
        """The ranks' ``t`` (same shape on each) stacked along dim 0 in rank
        order: (size * t.shape[0], ...) on ``t``'s device."""
        w = t.contiguous()
        if self.backend == "gloo" and w.is_cuda:
            w = w.cpu()  # gloo refuses a CUDA tensor here
        out = w.new_empty((self.size * w.shape[0],) + tuple(w.shape[1:]))
        # all_gather_single where torch has it (2.13 deprecates
        # all_gather_into_tensor for it), else the older name
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, w)
        return out.to(t.device)

    def sharded_eval(self, fn, x):
        """``fn`` over the rows of ``x`` (M, ...) with the rows split in
        contiguous shards over the ranks (padded to a multiple of the world
        size) and the results gathered: (M, ...) on every rank, in order."""
        m = x.shape[0]
        per = -(-m // self.size)
        pad = per * self.size - m
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        local = fn(x[self.rank * per:(self.rank + 1) * per])
        return self.all_gather(local.contiguous())[:m]

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]

    def all_gather_object(self, obj):
        """Every rank's picklable ``obj``, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def state_digests(state) -> dict:
    """sha256 of the bytes of a train state's replicated parts: the
    parameters, the optimizer's moments, the occupancy grids, the model's
    extra state and the generator (host copies; ranks of a run must agree)."""
    from instant_nsr_pl_tpu_torch.utils.transplant import state_dict

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy())
        return h.hexdigest()

    params = state_dict(state["params"])
    opt = state["optimizer"].optimizer
    moments = [opt.state[p][k] for g in opt.param_groups for p in g["params"]
               for k in sorted(opt.state.get(p, {})) if torch.is_tensor(opt.state[p][k])]
    grids = [t for name in sorted(state["occ"]) for t in state["occ"][name]]
    extra = state.get("extra", {})
    return {
        "params": digest(params[k] for k in sorted(params)),
        "moments": digest(moments),
        "grid": digest(grids),
        "extra": digest(extra[k] for k in sorted(extra)),
        "generator": digest([state["generator"].get_state()]),
        "step": int(state["step"]),
    }
