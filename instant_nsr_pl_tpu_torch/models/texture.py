"""Radiance head.

Port of ``instant_nsr_pl_tpu/models/texture.py:24-115`` (``VolumeRadiance``,
reference models/texture.py:10-36): geometry features, an SH-encoded view
direction and optional extras (NeuS normals) through a small MLP.
"""

from __future__ import annotations

import torch

from instant_nsr_pl_tpu_torch.models.network_utils import (
    CompositeEncoding,
    SphericalHarmonicsEncoding,
    get_encoding,
    get_mlp,
)
from instant_nsr_pl_tpu_torch.ops.activations import get_activation
from instant_nsr_pl_tpu_torch.ops.sh_mlp import fusable, sh_mlp_forward
from instant_nsr_pl_tpu_torch.registry import models


@models.register("volume-radiance")
class VolumeRadiance:
    def __init__(self, config):
        self.config = config
        self.n_dir_dims = int(config.get("n_dir_dims", 3))
        self.n_output_dims = 3
        self.dir_encoding = get_encoding(self.n_dir_dims, config.dir_encoding_config)
        self.n_input_dims = int(config.input_feature_dim) + self.dir_encoding.n_output_dims
        self.network = get_mlp(self.n_input_dims, self.n_output_dims, config.mlp_network_config)
        # applied ONLY when configured (reference models/texture.py:33-35):
        # NeRF configs put Sigmoid on the MLP's output_activation instead
        self.color_activation = (
            get_activation(config.color_activation) if "color_activation" in config else None
        )
        # fused SH + MLP op (ops/sh_mlp.py) whenever the head is fusable; the
        # dims are re-checked per call because extras arrive at call time
        inner = getattr(self.dir_encoding, "encoding", None)
        sh_ok = (
            isinstance(self.dir_encoding, CompositeEncoding)
            and not self.dir_encoding.include_xyz
            and isinstance(inner, SphericalHarmonicsEncoding)
        )
        self._sh_degree = inner.degree if sh_ok else None
        n_feat = self.n_input_dims - self.dir_encoding.n_output_dims
        self.fused = (
            sh_ok
            and bool(config.get("fused", True))
            and fusable(self.network.spec, n_feat, self._sh_degree)
        )

    def init(self, generator, device=None):
        return {
            "dir_encoding": self.dir_encoding.init(generator, device),
            "network": self.network.init(generator, device),
        }

    def apply(self, params, features, dirs, *extras):
        """features (N, D), dirs (N, 3) unit world dirs, extras e.g. normals."""
        n_feat = features.shape[-1] + sum(e.shape[-1] for e in extras)
        if self.fused and n_feat + self.dir_encoding.n_output_dims == self.network.spec.dim_in:
            feats_all = torch.cat([features, *extras], dim=-1) if extras else features
            color = sh_mlp_forward(
                params["network"]["layers"],
                feats_all.float(),
                dirs,
                self.network.spec,
                self._sh_degree,
                features.shape[-1],
            )
            color = self.network.output_activation(color)
        else:
            d = (dirs + 1.0) / 2.0  # map to [0,1] (tcnn SH convention)
            # the SH encoding has no parameters (a state dict drops the key)
            dirs_embd = self.dir_encoding.apply(params.get("dir_encoding", {}), d)
            inp = torch.cat([features, dirs_embd, *extras], dim=-1).float()
            color = self.network.apply(params["network"], inp)
        if self.color_activation is not None:
            color = self.color_activation(color)
        return color
