"""Scene-domain contraction.

Port of ``instant_nsr_pl_tpu/ops/contraction.py:18-84`` (reference:
models/geometry.py:17-29): AABB, a linear remap of [-radius, radius] onto
[0, 1], and UN_BOUNDED_SPHERE, MipNeRF-360's ``(2 - 1/|x|) x/|x|`` outside
the unit ball of the scaled coordinates, the contracted [-2, 2] mapped onto
[0, 1]. The unbounded branches are branch-free (``torch.where``), as in the
JAX package.

:func:`contract_coords` is the coordinate-wise form the occupancy lookup
takes, rounded as the JAX package's compiled code rounds it on the CPU: the
AABB remap as a fused multiply-add, and in the unbounded branch ``x /
radius`` as a product with the float32 reciprocal and the squared norm as
``fma(z, z, fma(x, x, y * y))``; the rest is IEEE float32. XLA rounds ``(2 -
1/|x|) / |x|`` differently in a few percent of the points outside the ball
(by an ulp or two of the result), so there the two packages agree to a few
ulps, not to the bit.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops.activations import fma32, scale_anything


class ContractionType(enum.Enum):
    AABB = "aabb"
    UN_BOUNDED_SPHERE = "un_bounded_sphere"


def contract_to_unisphere(x, radius, contraction_type: ContractionType):
    """Map world coordinates (..., 3) into the unit cube [0, 1]^3."""
    if contraction_type == ContractionType.AABB:
        return scale_anything(x, (-radius, radius), (0.0, 1.0))
    if contraction_type == ContractionType.UN_BOUNDED_SPHERE:
        x = scale_anything(x, (-radius, radius), (0.0, 1.0))
        x = x * 2.0 - 1.0  # the AABB is at [-1, 1]
        mag = torch.linalg.norm(x, dim=-1, keepdim=True)
        safe = torch.clamp(mag, min=1e-12)
        contracted = (2.0 - 1.0 / safe) * (x / safe)
        x = torch.where(mag > 1.0, contracted, x)
        return x / 4.0 + 0.5  # (-inf, inf) lands in [0, 1]
    raise NotImplementedError(contraction_type)


def contract_coords(px, py, pz, radius, contraction_type: ContractionType):
    """Coordinate-wise :func:`contract_to_unisphere`: three (...,) tensors
    in, three out."""
    if contraction_type == ContractionType.AABB:
        s = 0.5 / radius
        return fma32(px, s, 0.5), fma32(py, s, 0.5), fma32(pz, s, 0.5)
    if contraction_type == ContractionType.UN_BOUNDED_SPHERE:
        inv_r = float(np.float32(1.0) / np.float32(radius))
        xs, ys, zs = px * inv_r, py * inv_r, pz * inv_r
        mag = torch.sqrt(fma32(zs, zs, fma32(xs, xs, ys * ys)))
        safe = torch.clamp(mag, min=1e-12)
        scale = torch.where(mag > 1.0, (2.0 - 1.0 / safe) / safe, torch.ones_like(mag))
        return xs * scale / 4.0 + 0.5, ys * scale / 4.0 + 0.5, zs * scale / 4.0 + 0.5
    raise NotImplementedError(contraction_type)


def uncontract_from_unisphere(u, radius, contraction_type: ContractionType):
    """Inverse of :func:`contract_to_unisphere` (places occupancy-grid cell
    samples back in world space). The unbounded inverse ``|x| = 1 / (2 -
    |c|)`` keeps the JAX package's clamp of ``2 - |c|`` at 1e-6, so the
    outermost cells' samples land at radius up to ~1e6, never at inf."""
    if contraction_type == ContractionType.AABB:
        return scale_anything(u, (0.0, 1.0), (-radius, radius))
    if contraction_type == ContractionType.UN_BOUNDED_SPHERE:
        c = u * 4.0 - 2.0  # contracted coordinates in [-2, 2]
        mag = torch.linalg.norm(c, dim=-1, keepdim=True)
        safe = torch.clamp(mag, min=1e-12)
        inv = (c / safe) / torch.clamp(2.0 - safe, min=1e-6)
        x = torch.where(mag > 1.0, inv, c)
        return scale_anything((x + 1.0) / 2.0, (0.0, 1.0), (-radius, radius))
    raise NotImplementedError(contraction_type)
