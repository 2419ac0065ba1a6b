"""Systems (the reference's systems/ package role): NeRF and NeuS."""

import instant_nsr_pl_tpu_torch.models  # noqa: F401  (register model classes)
from instant_nsr_pl_tpu_torch.systems import nerf, neus  # noqa: F401  (register)
from instant_nsr_pl_tpu_torch.systems.base import BaseSystem  # noqa: F401
