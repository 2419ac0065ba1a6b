"""Data-parallel training over ranks of a process group (the reference's DDP
role; port of ``instant_nsr_pl_tpu/parallel``): ``distributed`` joins the
ranks and holds their collectives, ``data_parallel`` the plan that trains,
updates the occupancy grid and renders over them."""

from instant_nsr_pl_tpu_torch.parallel.data_parallel import DataParallelPlan  # noqa: F401
from instant_nsr_pl_tpu_torch.parallel.distributed import (  # noqa: F401
    Group,
    maybe_initialize_distributed,
)
