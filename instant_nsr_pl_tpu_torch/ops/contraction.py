"""Scene-domain contraction, AABB case.

Port of ``instant_nsr_pl_tpu/ops/contraction.py:18-84`` (reference:
models/geometry.py:17-29). The unbounded-sphere contraction belongs to the
unbounded-scene slice and raises here.
"""

from __future__ import annotations

import enum

from instant_nsr_pl_tpu_torch.ops.activations import scale_anything


class ContractionType(enum.Enum):
    AABB = "aabb"
    UN_BOUNDED_SPHERE = "un_bounded_sphere"


def _unported(contraction_type):
    return NotImplementedError(
        f"{contraction_type} contraction comes with the unbounded-scene "
        "slice of the port; only AABB is ported"
    )


def contract_to_unisphere(x, radius, contraction_type: ContractionType):
    """Map world coordinates into the unit cube [0, 1]^3 (AABB: linear remap
    of [-radius, radius])."""
    if contraction_type == ContractionType.AABB:
        return scale_anything(x, (-radius, radius), (0.0, 1.0))
    raise _unported(contraction_type)


def uncontract_from_unisphere(u, radius, contraction_type: ContractionType):
    """Inverse of :func:`contract_to_unisphere`."""
    if contraction_type == ContractionType.AABB:
        return scale_anything(u, (0.0, 1.0), (-radius, radius))
    raise _unported(contraction_type)
