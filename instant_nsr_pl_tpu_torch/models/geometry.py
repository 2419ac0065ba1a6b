"""Implicit geometry fields: NeRF density.

Port of ``instant_nsr_pl_tpu/models/geometry.py:58-108`` (``VolumeDensity``,
reference models/geometry.py:115-140). The SDF geometry belongs to the NeuS
slice.
"""

from __future__ import annotations

from instant_nsr_pl_tpu_torch.models.network_utils import get_encoding_with_network
from instant_nsr_pl_tpu_torch.ops.activations import get_activation
from instant_nsr_pl_tpu_torch.ops.contraction import ContractionType, contract_to_unisphere
from instant_nsr_pl_tpu_torch.registry import models


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

    def apply(self, params, points):
        """points: (..., 3) world -> (density (...,), feature (..., D))."""
        pts = contract_to_unisphere(points, self.radius, self.contraction_type)
        out = self.encoding_with_network.apply(
            params, pts.reshape(-1, self.n_input_dims)
        ).reshape(*points.shape[:-1], self.n_output_dims)
        out = out.float()
        density = self.density_activation(out[..., 0] + self.density_bias)
        return density, out
