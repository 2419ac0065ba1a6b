"""Dataset loaders (the reference's datasets/ package role)."""

from instant_nsr_pl_tpu_torch.datasets import synthetic  # noqa: F401
