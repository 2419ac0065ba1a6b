"""CP (CANDECOMP/PARAFAC) factorized line encoding.

Port of ``instant_nsr_pl_tpu/ops/cp.py``. Features are products of per-axis
line interpolations projected by a per-scale basis,

    feat_s(x) = ( Lx_s(x0) * Ly_s(x1) * Lz_s(x2) ) @ B_s        (N, C)->(N, F)

with bf16 line tables. Two implementations, as in the JAX package:

- ``impl="xla"``: the composed formula, interpolation weights applied in f32
  after the row reads; plain PyTorch ops, differentiable at any order (the
  fused density op ``ops/cp_mlp.py`` is held against it);
- ``impl="fast"`` (the JAX package's ``"pallas"``): per scale the CP product
  op of ``ops/cp_product.py`` (K5/K6 on the card), then the basis projection
  with bf16 operands and f32 sums. First-order only.

:func:`cp_encode_with_jac` returns the encoding and its position Jacobian,
per scale from one ``cp_product_jac_basis`` op (K9/K10) in the fast
implementation, or, with ``stacked=True`` (nested resolutions), for all scales
from one ``cp_jac_basis_stacked`` op (K11/K12, ``ops/cp_stacked.py``).
:func:`cp_encode` stays per scale, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from instant_nsr_pl_tpu_torch.ops.activations import clip
from instant_nsr_pl_tpu_torch.ops.cp_product import cp_product, cp_product_jac_basis
from instant_nsr_pl_tpu_torch.ops.cp_stacked import cp_jac_basis_stacked, stackable
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
    p = clip(u.float(), 0.0, 1.0) * (res - 1)
    i0 = torch.clamp(torch.floor(p), 0.0, float(res - 2))
    f = (p - i0)[:, None]
    lb = bf16_round(line)
    i0l = i0.long()
    return (1.0 - f) * lb[i0l] + f * lb[i0l + 1]


def cp_encode(params, x, spec: CPSpec, impl: str = "xla"):
    """CP encode: positions (..., 3) in [0,1] -> (..., n_output_dims)."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    outs = []
    if impl == "fast":
        u3 = xf.float().T.contiguous()
        for s, r in enumerate(spec.resolutions):
            prod = cp_product(params[f"line_{s}_0"], params[f"line_{s}_1"],
                              params[f"line_{s}_2"], u3, r)  # (C, N)
            if spec.n_features > 0:
                outs.append(bf16_round(prod).T @ bf16_round(params[f"basis_{s}"]))
            else:
                outs.append(prod.T)
    elif impl == "xla":
        for s, r in enumerate(spec.resolutions):
            g = _line_interp(params[f"line_{s}_0"], xf[:, 0], r)
            g = g * _line_interp(params[f"line_{s}_1"], xf[:, 1], r)
            g = g * _line_interp(params[f"line_{s}_2"], xf[:, 2], r)
            if spec.n_features > 0:
                g = bf16_round(g) @ bf16_round(params[f"basis_{s}"])
            outs.append(g)
    else:
        raise ValueError(f"cp_encode: unknown impl '{impl}'")
    out = torch.cat(outs, dim=-1)
    return out.reshape(*batch_shape, spec.n_output_dims).to(x.dtype)


def cp_encode_with_jac(params, x, spec: CPSpec, impl: str = "fast", stacked: bool = False):
    """(encoded (..., E), d encoded / d x (3, ..., E)).

    ``impl="fast"``: one ``cp_product_jac_basis`` op per scale (K9/K10 on the
    card; needs ``n_features > 0``), the scales concatenated; with
    ``stacked``, one ``cp_jac_basis_stacked`` op for all scales (K11/K12;
    needs nested resolutions too). ``impl="xla"``: the composed formula and
    its Jacobian by forward-mode differentiation, one tangent per input axis
    (the JAX twin's ``jacfwd``), differentiable at any order."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    e = spec.n_output_dims
    if impl == "fast" and stacked:
        assert spec.n_features > 0 and stackable(spec), spec
        enc, jac = cp_jac_basis_stacked(params, xf.float().T.contiguous(), spec)  # (E, N), (3, E, N)
        return (enc.T.reshape(*batch_shape, e).to(x.dtype),
                jac.transpose(1, 2).reshape(3, *batch_shape, e).to(x.dtype))
    if impl == "fast":
        if spec.n_features <= 0:
            raise NotImplementedError(
                "cp_encode_with_jac without a basis (n_features: 0, cp_product_jac) "
                "comes with the next slice of the port")
        u3 = xf.float().T.contiguous()
        encs, jacs = [], []
        for s, r in enumerate(spec.resolutions):
            enc, jac = cp_product_jac_basis(
                params[f"line_{s}_0"], params[f"line_{s}_1"], params[f"line_{s}_2"],
                params[f"basis_{s}"], u3, r)  # (F, N), (3, F, N)
            encs.append(enc)
            jacs.append(jac)
        enc = torch.cat(encs, dim=0).T
        jac = torch.cat(jacs, dim=1).transpose(1, 2)
        return (enc.reshape(*batch_shape, e).to(x.dtype),
                jac.reshape(3, *batch_shape, e).to(x.dtype))
    if impl != "xla":
        raise ValueError(f"cp_encode_with_jac: unknown impl '{impl}'")
    import torch.autograd.forward_ad as fwad

    enc = cp_encode(params, xf, spec, impl="xla")
    jacs = []
    for d in range(3):
        tangent = torch.zeros_like(xf)
        tangent[:, d] = 1.0
        with fwad.dual_level():
            out = cp_encode(params, fwad.make_dual(xf, tangent), spec, impl="xla")
            jacs.append(fwad.unpack_dual(out).tangent)
    jac = torch.stack(jacs)
    return (enc.reshape(*batch_shape, e).to(x.dtype),
            jac.reshape(3, *batch_shape, e).to(x.dtype))
