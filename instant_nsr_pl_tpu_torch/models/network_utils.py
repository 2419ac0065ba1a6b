"""Encoding / MLP factories (the reference's models/network_utils.py role).

Port of ``instant_nsr_pl_tpu/models/network_utils.py`` for the encodings the
NeRF and NeuS slices run: ``CP`` (with its Jacobian path) and
``SphericalHarmonics``. As in the JAX package,
every module is a static Python object with ``init(generator, device) ->
params`` and ``apply(params, x) -> out``, and parameters are nested dicts
keyed like the JAX pytree (``cp.line_{s}_{ax}``, ``layers[i].w``), so weights
carry across as copies (``utils/transplant.py``).

Training hands the tree's leaves to the optimizer: :func:`named_leaves`
lists them in the JAX package's flatten order and :func:`make_trainable`
turns them into leaf tensors that require grad. Gradients reach every leaf
through the fused ops' autograd Functions (``ops/cp_mlp.py``,
``ops/sh_mlp.py``) or, on the composed paths, through plain PyTorch ops.
"""

from __future__ import annotations

import torch

from instant_nsr_pl_tpu_torch.ops.activations import elementwise_jvp, get_activation
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_encode, cp_encode_with_jac, cp_init
from instant_nsr_pl_tpu_torch.ops.cp_mlp import (
    cp_mlp_forward,
    cp_mlp_stacked_forward,
    fusable,
    fusable_stacked,
)
from instant_nsr_pl_tpu_torch.ops.cp_stacked import stackable
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_apply, mlp_apply_jvp, mlp_init
from instant_nsr_pl_tpu_torch.ops.sh import sh_output_dim, spherical_harmonics_encoding


def named_leaves(tree, prefix=""):
    """(dotted key, tensor) pairs of a parameter tree in the JAX package's
    flatten order: dict keys sorted, list entries in order."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += named_leaves(v, f"{prefix}.{k}" if prefix else k)
    return out


def make_trainable(tree):
    """Make every parameter of ``tree`` require grad, in place (the init
    draws them as leaf tensors); returns the tree."""
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    return tree


_LATER = {
    "VanillaFrequency": "the HashGrid-family slice",
    "ProgressiveBandHashGrid": "the HashGrid-family slice",
    "HashGrid": "the HashGrid-family slice",
    "VectorMatrix": "the HashGrid-family slice",
    "VM": "the HashGrid-family slice",
}


class CPEncoding:
    """CP (line-factorized) encoding (``ops/cp.py``). The fused density op
    (``ops/cp_mlp.py``) takes over inside :class:`EncodingWithNetwork` when
    the pair is fusable.

    ``grad_mode`` ('fast' by default, the kernel path): 'fast' runs the CP
    product op (``ops/cp_product.py``: K5/K6 on the card) and, for
    :meth:`apply_with_jac`, the product-with-Jacobian op (K9/K10); 'autodiff'
    keeps the composed formula, differentiable at any order (the NeuS
    analytic-gradient fallback switches to it, ``models/geometry.py``).

    ``stack_scales`` (nested resolutions, e.g. (129, 2049)): the fused density
    op and :meth:`apply_with_jac` run every scale on the finest grid
    (``ops/cp_stacked.py``: K13/K14 and K11/K12); :meth:`apply` stays per
    scale."""

    def __init__(self, in_channels, config):
        if in_channels != 3:
            raise ValueError("CP encoding is 3-D")
        self.spec = CPSpec.from_config(config)
        self.stack_scales = bool(config.get("stack_scales", False))
        if self.stack_scales and not stackable(self.spec):
            raise ValueError(
                "stack_scales needs nested resolutions: (R_max-1) must be a multiple of "
                f"every (R_s-1); got {self.spec}"
            )
        self.n_input_dims = 3
        self.n_output_dims = self.spec.n_output_dims
        self.grad_mode = str(config.get("grad_mode", "fast"))
        if self.grad_mode not in ("fast", "autodiff"):
            raise ValueError(f"CP grad_mode must be 'fast' or 'autodiff', got {self.grad_mode}")
        if self.grad_mode == "fast" and self.spec.n_components % 8:
            raise ValueError(f"grad_mode: fast needs n_components divisible by 8; got {self.spec}")

    def init(self, generator, device=None):
        return {"cp": cp_init(generator, self.spec, device)}

    def _impl(self):
        return "fast" if self.grad_mode == "fast" else "xla"

    def apply(self, params, x):
        return cp_encode(params["cp"], x, self.spec, impl=self._impl())

    def apply_with_jac(self, params, x):
        """(feat (..., E), d feat / d x (3, ..., E)) from one product-with-
        Jacobian op per scale, or one for all scales with ``stack_scales``
        (``ops/cp.py`` ``cp_encode_with_jac``)."""
        impl = self._impl()
        return cp_encode_with_jac(params["cp"], x, self.spec, impl=impl,
                                  stacked=self.stack_scales and impl == "fast")


class SphericalHarmonicsEncoding:
    """Real-SH direction encoding (tcnn ``SphericalHarmonics`` role)."""

    def __init__(self, in_channels, config):
        if in_channels != 3:
            raise ValueError("SH encoding is 3-D")
        self.degree = int(config["degree"])
        self.n_input_dims = 3
        self.n_output_dims = sh_output_dim(self.degree)

    def init(self, generator, device=None):
        return {}

    def apply(self, params, x):
        return spherical_harmonics_encoding(x, self.degree)


class CompositeEncoding:
    """Optionally prepend the raw (rescaled) input to the encoding output
    (``include_xyz``; reference: models/network_utils.py:68-79)."""

    def __init__(self, encoding, include_xyz=False, xyz_scale=2.0, xyz_offset=-1.0):
        self.encoding = encoding
        self.include_xyz = include_xyz
        self.xyz_scale = xyz_scale
        self.xyz_offset = xyz_offset
        self.n_input_dims = encoding.n_input_dims
        self.n_output_dims = (
            int(include_xyz) * encoding.n_input_dims + encoding.n_output_dims
        )

    def init(self, generator, device=None):
        return self.encoding.init(generator, device)

    def apply(self, params, x):
        enc = self.encoding.apply(params, x)
        if not self.include_xyz:
            return enc
        return torch.cat([x * self.xyz_scale + self.xyz_offset, enc], dim=-1)

    @property
    def has_jac(self) -> bool:
        return hasattr(self.encoding, "apply_with_jac")

    def apply_with_jac(self, params, x):
        """(feat (..., D), jac (3, ..., D)) including the identity block of
        the prepended xyz channels (d(x * s + o)/dx = s * I)."""
        enc, jac = self.encoding.apply_with_jac(params, x)
        if not self.include_xyz:
            return enc, jac
        feat = torch.cat([x * self.xyz_scale + self.xyz_offset, enc], dim=-1)
        eye = torch.eye(3, dtype=jac.dtype, device=jac.device) * self.xyz_scale
        jac_xyz = eye.reshape(3, *(1,) * (x.ndim - 1), 3).expand(3, *x.shape[:-1], 3)
        return feat, torch.cat([jac_xyz, jac], dim=-1)


def get_encoding(n_input_dims, config):
    """Factory mirroring reference get_encoding (network_utils.py:82-92);
    input is assumed to live in [0, 1]."""
    otype = config["otype"]
    if otype in ("CP", "TensorCP"):
        enc = CPEncoding(n_input_dims, config)
    elif otype == "SphericalHarmonics":
        enc = SphericalHarmonicsEncoding(n_input_dims, config)
    elif otype in _LATER:
        raise NotImplementedError(
            f"encoding otype '{otype}' comes with {_LATER[otype]} of the port"
        )
    else:
        raise ValueError(f"Unknown encoding otype '{otype}'")
    return CompositeEncoding(enc, include_xyz=bool(config.get("include_xyz", False)))


class MLP:
    """Functional MLP wrapping ops/mlp.py with the configured output
    activation (FullyFusedMLP / CutlassMLP / VanillaMLP roles)."""

    def __init__(self, dim_in, dim_out, config):
        self.spec = MLPSpec.from_config(dim_in, dim_out, config)
        self.output_activation = get_activation(config.get("output_activation", "none"))
        self.n_input_dims = dim_in
        self.n_output_dims = dim_out

    def init(self, generator, device=None):
        return {"layers": mlp_init(generator, self.spec, device)}

    def apply(self, params, x):
        return self.output_activation(mlp_apply(params["layers"], x, self.spec))

    def apply_jvp(self, params, x, tangents):
        """(apply(params, x), its derivatives along ``tangents`` (K, N, dim_in)
        -> (K, N, dim_out)): the forward-mode linearization of the network."""
        out, tout = mlp_apply_jvp(params["layers"], x, self.spec, tangents)
        if self.spec.output_activation.lower() != "none":
            out, tout = elementwise_jvp(self.output_activation, out, tout)
        return out, tout


def get_mlp(n_input_dims, n_output_dims, config):
    """Factory mirroring reference get_mlp (network_utils.py:176-184)."""
    return MLP(n_input_dims, n_output_dims, config)


class EncodingWithNetwork:
    """Encoding + MLP (tcnn ``NetworkWithInputEncoding`` role, reference
    network_utils.py:187-215).

    When the encoding is CP in ``grad_mode: fast`` without ``include_xyz``
    and the pair is ``fusable`` (a bf16 ReLU MLP of kernel-friendly widths),
    the whole chain
    runs as ONE fused op (``ops/cp_mlp.py``: the CUDA kernel on the card, its
    plain version on the CPU), the stacked-scales one with ``stack_scales``.
    Everything else composes encoding -> MLP."""

    def __init__(self, encoding, network):
        self.encoding = encoding
        self.network = network
        self.n_input_dims = encoding.n_input_dims
        self.n_output_dims = network.n_output_dims
        inner = getattr(encoding, "encoding", None)
        self.fused = (
            isinstance(encoding, CompositeEncoding)
            and not encoding.include_xyz
            and isinstance(inner, CPEncoding)
            and inner.grad_mode == "fast"
            and (fusable_stacked if inner.stack_scales else fusable)(inner.spec, network.spec)
        )

    def init(self, generator, device=None):
        return {
            "encoding": self.encoding.init(generator, device),
            "network": self.network.init(generator, device),
        }

    def apply(self, params, x):
        if self.fused:
            inner = self.encoding.encoding
            op = cp_mlp_stacked_forward if inner.stack_scales else cp_mlp_forward
            out = op(
                params["encoding"]["cp"],
                params["network"]["layers"],
                x,
                inner.spec,
                self.network.spec,
            )
            return self.network.output_activation(out)
        return self.network.apply(
            params["network"], self.encoding.apply(params["encoding"], x)
        )


def get_encoding_with_network(n_input_dims, n_output_dims, encoding_config, network_config):
    encoding = get_encoding(n_input_dims, encoding_config)
    network = get_mlp(encoding.n_output_dims, n_output_dims, network_config)
    return EncodingWithNetwork(encoding, network)
