"""Implicit geometry fields: NeRF density and the NeuS SDF.

Port of ``instant_nsr_pl_tpu/models/geometry.py`` (``VolumeDensity``
:58-108, reference models/geometry.py:115-140; ``VolumeSDF`` :111-313,
reference models/geometry.py:143-238). Both extract their mesh with
``isosurface`` (``models/isosurface.py``) from ``forward_level``, the field
that is negative inside.
"""

from __future__ import annotations

import torch

from instant_nsr_pl_tpu_torch.models.isosurface import extract_isosurface
from instant_nsr_pl_tpu_torch.models.network_utils import (
    CPEncoding,
    ProgressiveBandHashGrid,
    get_encoding,
    get_encoding_with_network,
    get_mlp,
    on_cuda,
    params_device,
)
from instant_nsr_pl_tpu_torch.ops.activations import elementwise_jvp, get_activation
from instant_nsr_pl_tpu_torch.ops.contraction import ContractionType, contract_to_unisphere
from instant_nsr_pl_tpu_torch.registry import models


def isosurface(geometry, params, step=None):
    """The two-stage marching pass of ``geometry`` (its ``config.isosurface``
    section), the level grid evaluated on the parameters' device at training
    step ``step``: a dict with ``v_pos`` (V, 3) float32 and ``t_pos_idx``
    (F, 3) int64 numpy arrays."""
    return extract_isosurface(geometry, params, params_device(params), step=step)


@models.register("volume-density")
class VolumeDensity:
    """NeRF geometry: contraction -> encoding + MLP -> (density, feature)."""

    def __init__(self, config):
        self.config = config
        self.radius = float(config.radius)
        self.contraction_type = ContractionType.AABB  # assigned by the renderer
        self.n_input_dims = int(config.get("n_input_dims", 3))
        self.n_output_dims = int(config.feature_dim)
        self.encoding_with_network = get_encoding_with_network(
            self.n_input_dims,
            self.n_output_dims,
            config.xyz_encoding_config,
            config.mlp_network_config,
        )
        self.density_activation = get_activation(
            config.get("density_activation", "trunc_exp")
        )
        self.density_bias = float(config.get("density_bias", 0.0))

    def init(self, generator, device=None):
        return self.encoding_with_network.init(generator, device)

    def apply(self, params, points, step=None, grouped=False):
        """points: (..., 3) world -> (density (...,), feature (..., D)) at
        training step ``step`` (a progressive encoding's level mask).
        ``grouped`` asserts that the flattened points are the group-compacted
        march's aligned uniform-step blocks (a hash encoding's dedup spec)."""
        pts = contract_to_unisphere(points, self.radius, self.contraction_type)
        out = self.encoding_with_network.apply(
            params, pts.reshape(-1, self.n_input_dims), step=step, grouped=grouped
        ).reshape(*points.shape[:-1], self.n_output_dims)
        out = out.float()
        density = self.density_activation(out[..., 0] + self.density_bias)
        return density, out

    def configure_dedup(self, group: int, step: float):
        """Forward the renderer's aligned-block guarantee to a hash encoding
        (no-op for other encodings); ``step`` in [0, 1] coordinates."""
        self.encoding_with_network.encoding.configure_dedup(group, step)

    def forward_level(self, params, points, step=None):
        """Level-set field for marching (negative inside): -density, so the
        surface at density ``threshold`` lies at level -threshold."""
        density, _ = self.apply(params, points, step=step)
        return -density

    def isosurface(self, params, step=None):
        return isosurface(self, params, step)


_STENCIL = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


@models.register("volume-sdf")
class VolumeSDF:
    """SDF geometry with analytic or finite-difference gradients.

    Analytic gradients are differentiated again by the eikonal loss (a
    second-order graph). Two constructions, as in the JAX package:

    - the jac path (the default when the encoding has one, as on the TPU):
      the encoding returns (feature, its analytic position Jacobian) from one
      op per scale (``cp_product_jac_basis``, K9/K10 on the card, or
      ``cp_product_jac``, K7/K8, without a basis; K11/K12 for stacked
      scales; ``hashgrid_encode_with_jac``, HG3/HG4, for a hash grid), and
      the SDF gradient is ``J_enc^T dsdf/denc * 0.5 / radius`` with the MLP
      part as a forward-mode tangent through the plain fp32 MLP
      (:meth:`MLP.apply_jvp`): the second-order graph never meets a custom op
      and works under ``no_grad`` for eval;
    - the autodiff fallback (``analytic_jac: false``): the encoding switches
      to its composed formula (``grad_mode: autodiff``) and the gradient is
      ``torch.autograd.grad(create_graph=True)`` through it.

    ``grad_type: finite_difference`` (Neuralangelo) evaluates a 6-point
    stencil through the plain encode (K5/K6 on the card, HG1/HG2 with a hash
    grid) and, with ``with_laplace``, the Laplacian for the curvature loss;
    ``finite_difference_eps: progressive`` ties the stencil's eps to the cell
    of a ``ProgressiveBandHashGrid``'s current level.

    ``step`` (a Python int, None outside training) reaches the encoding
    through every evaluation: a progressive encoding's level mask follows
    it."""

    def __init__(self, config):
        self.config = config
        self.radius = float(config.radius)
        self.contraction_type = ContractionType.AABB  # assigned by the renderer
        self.n_output_dims = int(config.feature_dim)
        self.encoding = get_encoding(3, config.xyz_encoding_config)
        self.network = get_mlp(
            self.encoding.n_output_dims, self.n_output_dims, config.mlp_network_config
        )
        self.grad_type = str(config.get("grad_type", "analytic"))
        if self.grad_type not in ("analytic", "finite_difference"):
            raise ValueError(f"unknown grad_type '{self.grad_type}'")
        inner = getattr(self.encoding, "encoding", self.encoding)
        self.use_jac = False
        if self.grad_type == "analytic":
            jac_capable = getattr(self.encoding, "has_jac", False)
            self.use_jac = bool(config.get("analytic_jac", jac_capable))
            if self.use_jac and not jac_capable:
                raise ValueError("analytic_jac: true requires an encoding with a jac path")
            if not self.use_jac and hasattr(inner, "grad_mode"):
                inner.grad_mode = "autodiff"
        self.fd_eps_config = config.get("finite_difference_eps", 1e-3)
        if self.grad_type == "finite_difference" and not isinstance(
                self.fd_eps_config, (int, float)):
            otype = config.xyz_encoding_config.otype
            if self.fd_eps_config != "progressive" or not isinstance(
                    inner, ProgressiveBandHashGrid):
                raise ValueError(
                    f"finite_difference_eps: {self.fd_eps_config!r} needs 'progressive' and a "
                    f"ProgressiveBandHashGrid encoding, got otype {otype!r}")
        self.sdf_activation = (
            get_activation(config.sdf_activation) if "sdf_activation" in config else None
        )
        self.sdf_bias = float(config.get("sdf_bias", 0.0))

    def init(self, generator, device=None):
        """Parameters on ``device``. For the card, a CP encoding's kernels
        (the product and, on the jac path, the product with its Jacobian)
        must exist at its shape, else ValueError."""
        inner = self.encoding.encoding
        if on_cuda(device) and isinstance(inner, CPEncoding):
            inner.check_instantiated()
            if self.use_jac:
                inner.check_instantiated(jac=True)
        return {
            "encoding": self.encoding.init(generator, device),
            "network": self.network.init(generator, device),
        }

    def _sdf(self, out):
        sdf = out[..., 0]
        if self.sdf_activation is not None:
            sdf = self.sdf_activation(sdf + self.sdf_bias)
        return sdf

    def _field(self, params, points, step=None):
        """(N, 3) world -> (sdf (N,), feature (N, D))."""
        pts = contract_to_unisphere(points, self.radius, self.contraction_type)
        out = self.network.apply(
            params["network"], self.encoding.apply(params["encoding"], pts, step=step)
        ).float()
        return self._sdf(out), out

    def configure_dedup(self, group: int, step: float):
        """Forward the renderer's aligned-block guarantee to a hash encoding
        (no-op for other encodings)."""
        self.encoding.configure_dedup(group, step)

    def finite_difference_eps(self, step=None):
        """The stencil's eps, a float32 scalar tensor: the configured number,
        or with 'progressive' the cell of the current level,
        ``2 r / (base_resolution * scale ** (level - 1))`` in float32 (JAX
        ``finite_difference_eps``, reference models/geometry.py:219-238)."""
        if isinstance(self.fd_eps_config, (int, float)):
            return torch.tensor(float(self.fd_eps_config), dtype=torch.float32)
        enc = self.encoding.encoding
        level = enc.current_level(step)
        grid_res = enc.spec.base_resolution * torch.tensor(
            enc.spec.per_level_scale, dtype=torch.float32) ** (level - 1)
        return torch.tensor(2.0 * self.radius, dtype=torch.float32) / grid_res

    def apply(self, params, points, step=None, with_grad=True, with_feature=True,
              with_laplace=False, grouped=False):
        """Returns (sdf, [grad,] [feature,] [laplace]), the reference's tuple
        protocol (models/geometry.py:158-210), at training step ``step``.
        ``grouped`` asserts aligned uniform-step blocks (the group-compacted
        march): the analytic jac path then takes the encoding's dedup spec;
        the finite-difference and autodiff paths stay per-sample (JAX
        ``models/geometry.py:213-231``)."""
        points = points.reshape(-1, 3)
        grad = feature = laplace = None
        if with_grad and self.grad_type == "analytic" and self.use_jac:
            if self.contraction_type != ContractionType.AABB:
                raise ValueError("analytic_jac supports AABB contraction only")
            pts = contract_to_unisphere(points, self.radius, self.contraction_type)
            enc, jac = self.encoding.apply_with_jac(params["encoding"], pts, step=step,
                                                    grouped=grouped)  # (N, E), (3, N, E)
            scale = 0.5 / self.radius  # d pts / d points (AABB is linear)
            out, tout = self.network.apply_jvp(params["network"], enc, jac * scale)
            feature = out.float()
            sdf = feature[..., 0]
            dsdf = tout[..., 0]  # (3, N)
            if self.sdf_activation is not None:
                sdf, dsdf = elementwise_jvp(
                    lambda s: self.sdf_activation(s + self.sdf_bias), sdf, dsdf)
            grad = dsdf.T
        elif with_grad and self.grad_type == "analytic":
            create = torch.is_grad_enabled()
            with torch.enable_grad():
                x = points if points.requires_grad else points.detach().requires_grad_(True)
                sdf, feature = self._field(params, x, step)
                (grad,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=create)
            if not create:
                sdf, feature = sdf.detach(), feature.detach()
        else:
            sdf, feature = self._field(params, points, step)
            if with_grad:  # finite differences (Neuralangelo)
                eps = self.finite_difference_eps(step).to(points.device)
                offsets = torch.tensor(_STENCIL, dtype=torch.float32, device=points.device)
                r = torch.tensor(self.radius, dtype=torch.float32, device=points.device)
                pts_d = torch.minimum(torch.maximum(points[:, None, :] + eps * offsets, -r), r)
                sdf_d, _ = self._field(params, pts_d.reshape(-1, 3), step)
                sdf_d = sdf_d.reshape(-1, 6)
                grad = 0.5 * (sdf_d[:, 0::2] - sdf_d[:, 1::2]) / eps
                if with_laplace:
                    laplace = (sdf_d[:, 0::2] + sdf_d[:, 1::2] - 2.0 * sdf[:, None]).sum(-1) / (
                        eps * eps)
        rv = [sdf]
        if with_grad:
            rv.append(grad)
        if with_feature:
            rv.append(feature)
        if with_laplace:
            if self.grad_type != "finite_difference":
                raise ValueError("laplace requires grad_type='finite_difference'")
            rv.append(laplace)
        return rv[0] if len(rv) == 1 else tuple(rv)

    def forward_level(self, params, points, step=None):
        """Scalar level-set field for marching cubes (negative inside)."""
        sdf, _ = self._field(params, points.reshape(-1, 3), step)
        return sdf.reshape(points.shape[:-1])

    def isosurface(self, params, step=None):
        return isosurface(self, params, step)
