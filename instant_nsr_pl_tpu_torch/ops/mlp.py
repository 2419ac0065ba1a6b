"""Functional MLPs (the tiny-cuda-nn FullyFusedMLP / VanillaMLP role).

Port of ``instant_nsr_pl_tpu/ops/mlp.py:29-144`` (reference:
models/network_utils.py:95-215). Parameters are a list of layer dicts
``{"w": (d_in, d_out), "b": (d_out,)}`` in the JAX layout, so weights carry
across as copies. Two precision policies:

- "bf16" (the fused density/color heads): every layer input is rounded to
  bf16, the product runs as a float32 matmul on bf16-valued operands (exact
  products, f32 accumulation), the f32 bias is added, and hidden activations
  are rounded to bf16 again;
- "fp32" (VanillaMLP): plain float32.

This composed chain is what the fused kernels' plain versions reuse. Sphere
init and weight norm belong to the NeuS slice and raise here.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    dim_in: int
    dim_out: int
    n_neurons: int = 64
    n_hidden_layers: int = 1
    activation: str = "ReLU"          # hidden activation (ReLU or Softplus100)
    output_activation: str = "none"   # applied by callers via get_activation
    sphere_init: bool = False
    sphere_init_radius: float = 0.5
    weight_norm: bool = False
    precision: str = "bf16"           # "bf16" (fused-style) or "fp32" (vanilla)

    @property
    def n_layers(self) -> int:
        return self.n_hidden_layers + 1

    @classmethod
    def from_config(cls, dim_in, dim_out, config, precision=None) -> "MLPSpec":
        otype = config.get("otype", "VanillaMLP")
        vanilla = otype == "VanillaMLP"
        return cls(
            dim_in=dim_in,
            dim_out=dim_out,
            n_neurons=int(config["n_neurons"]),
            n_hidden_layers=int(config["n_hidden_layers"]),
            activation=str(config.get("activation", "ReLU")),
            output_activation=str(config.get("output_activation", "none")),
            sphere_init=bool(config.get("sphere_init", False)),
            sphere_init_radius=float(config.get("sphere_init_radius", 0.5)),
            weight_norm=bool(config.get("weight_norm", False)),
            precision=precision or ("fp32" if vanilla else "bf16"),
        )


def _layer_dims(spec: MLPSpec):
    dims = [spec.dim_in] + [spec.n_neurons] * spec.n_hidden_layers + [spec.dim_out]
    return list(zip(dims[:-1], dims[1:]))


def _check_ported(spec: MLPSpec):
    if spec.sphere_init or spec.weight_norm:
        raise NotImplementedError(
            "sphere init and weight norm come with the NeuS slice of the port"
        )


def mlp_init(generator: torch.Generator, spec: MLPSpec, device=None):
    """Kaiming-uniform (fan_in, gain sqrt(2)) weights and zero biases, drawn
    from ``generator`` on the CPU and moved to ``device``."""
    _check_ported(spec)
    params = []
    for d_in, d_out in _layer_dims(spec):
        bound = math.sqrt(6.0 / d_in)
        w = torch.rand((d_in, d_out), generator=generator) * (2 * bound) - bound
        params.append({"w": w.to(device), "b": torch.zeros(d_out, device=device)})
    return params


def bf16_round(x):
    """Round float32 values to bf16 (round to nearest even), kept in f32."""
    return x.to(torch.bfloat16).float()


def _hidden_act(spec: MLPSpec, x):
    if spec.activation.lower().startswith("softplus"):
        beta = 100.0
        return torch.nn.functional.softplus(beta * x) / beta
    return torch.relu(x)


def mlp_apply(params, x, spec: MLPSpec, hidden=None):
    """Apply the MLP to (N, dim_in) -> (N, dim_out) float32. The output
    activation is NOT applied here (callers use the activation DSL). A list
    passed as ``hidden`` receives each hidden layer's (N, W) activation."""
    _check_ported(spec)
    bf16 = spec.precision == "bf16"
    h = bf16_round(x.float()) if bf16 else x.float()
    n = len(params)
    for li, layer in enumerate(params):
        w = bf16_round(layer["w"]) if bf16 else layer["w"].float()
        h = h @ w + layer["b"].float()
        if li < n - 1:
            h = _hidden_act(spec, h)
            if bf16:
                h = bf16_round(h)
            if hidden is not None:
                hidden.append(h)
    return h
