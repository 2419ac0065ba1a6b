"""CP (CANDECOMP/PARAFAC) factorized line encoding, composed path.

Port of ``instant_nsr_pl_tpu/ops/cp.py:47-169`` (the ``impl="xla"`` formula
of ``cp_encode``). Features are products of per-axis line interpolations
projected by a per-scale basis,

    feat_s(x) = ( Lx_s(x0) * Ly_s(x1) * Lz_s(x2) ) @ B_s        (N, C)->(N, F)

with the line tables rounded to bf16 and the interpolation weights applied in
f32 after the row reads. This composed path is what the fused density op
(``ops/cp_mlp.py``) is held against; the fused op rounds the interpolation
weights to bf16 as the TPU kernel does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from instant_nsr_pl_tpu_torch.ops.mlp import bf16_round


@dataclasses.dataclass(frozen=True)
class CPSpec:
    """Static description of a CP line encoding (hashable)."""

    n_components: int = 64
    resolutions: tuple[int, ...] = (128, 2048)
    n_features: int = 16  # per-scale projected features; 0 = raw products

    @property
    def n_output_dims(self) -> int:
        per = self.n_features if self.n_features > 0 else self.n_components
        return len(self.resolutions) * per

    @classmethod
    def from_config(cls, config) -> "CPSpec":
        res = config.get("resolutions", [128, 2048])
        return cls(
            n_components=int(config.get("n_components", 64)),
            resolutions=tuple(int(r) for r in res),
            n_features=int(config.get("n_features", 16)),
        )


def cp_init(generator: torch.Generator, spec: CPSpec, device=None):
    """TensoRF-style init: 0.1*N(0,1) line factors (R, C) and an
    N(0,1)/sqrt(C) projection basis (C, F), drawn on the CPU."""
    params = {}
    c = spec.n_components
    for s, r in enumerate(spec.resolutions):
        for ax in range(3):
            params[f"line_{s}_{ax}"] = (
                torch.randn((r, c), generator=generator) * 0.1
            ).to(device)
        if spec.n_features > 0:
            params[f"basis_{s}"] = (
                torch.randn((c, spec.n_features), generator=generator)
                / math.sqrt(c)
            ).to(device)
    return params


def _line_interp(line, u, res: int):
    """Linear interpolation of N scalars against an (R, C) line table:
    (N, C) float32, bf16 table rows, f32 weights applied after the reads."""
    p = torch.clamp(u.float(), 0.0, 1.0) * (res - 1)
    i0 = torch.clamp(torch.floor(p), 0.0, float(res - 2))
    f = (p - i0)[:, None]
    lb = bf16_round(line)
    i0l = i0.long()
    return (1.0 - f) * lb[i0l] + f * lb[i0l + 1]


def cp_encode(params, x, spec: CPSpec):
    """CP encode: positions (..., 3) in [0,1] -> (..., n_output_dims)."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    outs = []
    for s, r in enumerate(spec.resolutions):
        g = _line_interp(params[f"line_{s}_0"], xf[:, 0], r)
        g = g * _line_interp(params[f"line_{s}_1"], xf[:, 1], r)
        g = g * _line_interp(params[f"line_{s}_2"], xf[:, 2], r)
        if spec.n_features > 0:
            g = bf16_round(g) @ bf16_round(params[f"basis_{s}"])
        outs.append(g)
    out = torch.cat(outs, dim=-1)
    return out.reshape(*batch_shape, spec.n_output_dims).to(x.dtype)
