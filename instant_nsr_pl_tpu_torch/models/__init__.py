"""Renderers, geometries, textures (the reference's models/ package role)."""

from instant_nsr_pl_tpu_torch.models import geometry, nerf, neus, texture  # noqa: F401
