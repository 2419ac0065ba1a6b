"""Spherical-harmonics direction encoding.

Port of ``instant_nsr_pl_tpu/ops/sh.py`` (tiny-cuda-nn's
``SphericalHarmonics`` role, reference: models/texture.py:17): the real SH
basis of degree 1..4 on a direction given in [0, 1]^3, rescaled to [-1, 1].
"""

from __future__ import annotations

import torch

# constants of the real spherical harmonics basis (degrees 0..3); the CUDA
# kernels repeat them as float literals (csrc/sh_common.cuh)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_basis(x, y, z, degree: int):
    """The real SH basis of raw unit-direction components (each (...,)),
    as a list of degree**2 tensors, in f32 with the JAX twin's expressions."""
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return out


def spherical_harmonics_encoding(dirs, degree: int = 4):
    """Evaluate the real SH basis of the given degree.

    Args:
      dirs: (..., 3) directions in [0, 1] (tcnn convention), rescaled to
        [-1, 1] internally.
      degree: 1..4 (number of bands); the output has degree**2 features.
    Returns:
      (..., degree**2) float32 features.
    """
    if not 1 <= degree <= 4:
        raise ValueError("spherical_harmonics_encoding supports degree 1..4")
    d = dirs * 2.0 - 1.0
    return torch.stack(sh_basis(d[..., 0], d[..., 1], d[..., 2], degree), dim=-1)


def sh_output_dim(degree: int) -> int:
    return degree * degree
