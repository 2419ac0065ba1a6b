"""Dataset loaders (the reference's datasets/ package role)."""

from instant_nsr_pl_tpu_torch.datasets import blender, colmap, dtu, synthetic  # noqa: F401
