"""Functional MLPs (the tiny-cuda-nn FullyFusedMLP / VanillaMLP role).

Port of ``instant_nsr_pl_tpu/ops/mlp.py:29-144`` (reference:
models/network_utils.py:95-215). Parameters are a list of layer dicts
``{"w": (d_in, d_out), "b": (d_out,)}`` in the JAX layout, or ``{"v", "g",
"b"}`` with weight norm, so weights carry across as copies. Two precision
policies:

- "bf16" (the fused density/color heads): every layer input is rounded to
  bf16, the product runs as a float32 matmul on bf16-valued operands (exact
  products, f32 accumulation), the f32 bias is added, and hidden activations
  are rounded to bf16 again;
- "fp32" (VanillaMLP, the SDF network): plain float32, with sphere
  (geometric) init, optional weight norm ``w = v * g / max(||v||_0, 1e-12)``
  and Softplus(beta=100) hidden activations whenever sphere init is on.

This composed chain is what the fused kernels' plain versions reuse.
:func:`mlp_apply_jvp` pushes tangents through the same chain (the forward
mode ``jax.linearize`` gives the NeuS SDF gradient).
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


def mlp_init(generator: torch.Generator, spec: MLPSpec, device=None):
    """Initial layers drawn from ``generator`` on the CPU, moved to
    ``device``. Default: Kaiming-uniform (fan_in, gain sqrt(2)) weights and
    zero biases. Sphere init (reference network_utils.py:118-133): the last
    layer ~ N(sqrt(pi)/sqrt(d_in), 1e-4) with bias -r, the first layer zero
    beyond the 3 xyz rows and N(0, sqrt(2)/sqrt(d_out)) on them, hidden layers
    N(0, sqrt(2)/sqrt(d_out)). With weight norm each layer is ``{"v": w, "g":
    ||w||_0, "b": b}``."""
    params = []
    dims = _layer_dims(spec)
    for li, (d_in, d_out) in enumerate(dims):
        is_first, is_last = li == 0, li == len(dims) - 1
        b = torch.zeros(d_out)
        if spec.sphere_init:
            if is_last:
                w = torch.randn((d_in, d_out), generator=generator) * 1e-4 + (
                    math.sqrt(math.pi) / math.sqrt(d_in))
                b = torch.full((d_out,), -spec.sphere_init_radius)
            elif is_first:
                w = torch.zeros((d_in, d_out))
                w[:3] = torch.randn((3, d_out), generator=generator) * (
                    math.sqrt(2.0) / math.sqrt(d_out))
            else:
                w = torch.randn((d_in, d_out), generator=generator) * (
                    math.sqrt(2.0) / math.sqrt(d_out))
        else:
            bound = math.sqrt(6.0 / d_in)
            w = torch.rand((d_in, d_out), generator=generator) * (2 * bound) - bound
        if spec.weight_norm:
            layer = {"v": w, "g": torch.linalg.norm(w, dim=0), "b": b}
        else:
            layer = {"w": w, "b": b}
        params.append({k: t.to(device) for k, t in layer.items()})
    return params


def bf16_round(x):
    """Round float32 values to bf16 (round to nearest even), kept in f32."""
    return x.to(torch.bfloat16).float()


def _softplus_hidden(spec: MLPSpec) -> bool:
    # the JAX package switches to Softplus(100) whenever sphere init is on
    return spec.sphere_init or spec.activation.lower().startswith("softplus")


def _hidden_act(spec: MLPSpec, x):
    if _softplus_hidden(spec):
        beta = 100.0
        return torch.nn.functional.softplus(beta * x) / beta
    return torch.relu(x)


def _hidden_act_grad(spec: MLPSpec, x):
    """d hidden activation / d x at x: sigmoid(100 x) or the ReLU mask."""
    if _softplus_hidden(spec):
        return torch.sigmoid(100.0 * x)
    return (x > 0).to(x.dtype)


def layer_weight(layer):
    """A layer's (d_in, d_out) weight: ``w``, or ``v * g / max(||v||_0,
    1e-12)`` with weight norm."""
    if "v" in layer:
        v = layer["v"]
        norm = torch.linalg.norm(v, dim=0)
        return v * (layer["g"] / torch.maximum(norm, norm.new_tensor(1e-12)))
    return layer["w"]


def mlp_apply(params, x, spec: MLPSpec, hidden=None):
    """Apply the MLP to (N, dim_in) -> (N, dim_out) float32. The output
    activation is NOT applied here (callers use the activation DSL). A list
    passed as ``hidden`` receives each hidden layer's (N, W) activation."""
    bf16 = spec.precision == "bf16"
    h = bf16_round(x.float()) if bf16 else x.float()
    n = len(params)
    for li, layer in enumerate(params):
        w = layer_weight(layer)
        w = bf16_round(w) if bf16 else w.float()
        h = h @ w + layer["b"].float()
        if li < n - 1:
            h = _hidden_act(spec, h)
            if bf16:
                h = bf16_round(h)
            if hidden is not None:
                hidden.append(h)
    return h


def mlp_apply_jvp(params, x, spec: MLPSpec, tangents):
    """The MLP's output (N, dim_out) and its directional derivatives along
    ``tangents`` (K, N, dim_in) -> (K, N, dim_out): per layer ``t <- t @ W``,
    then times the hidden activation's derivative at the pre-activation, as
    ``jax.linearize`` of :func:`mlp_apply` computes them (bf16 roundings act
    on the tangents too). Differentiable by autograd, so a loss on the
    tangents (the eikonal term) reaches the weights at second order."""
    bf16 = spec.precision == "bf16"
    h = bf16_round(x.float()) if bf16 else x.float()
    t = bf16_round(tangents.float()) if bf16 else tangents.float()
    n = len(params)
    for li, layer in enumerate(params):
        w = layer_weight(layer)
        w = bf16_round(w) if bf16 else w.float()
        z = h @ w + layer["b"].float()
        t = t @ w
        if li < n - 1:
            t = t * _hidden_act_grad(spec, z)
            h = _hidden_act(spec, z)
            if bf16:
                h, t = bf16_round(h), bf16_round(t)
        else:
            h = z
    return h, t
