"""Encoding / MLP factories (the reference's models/network_utils.py role).

Port of ``instant_nsr_pl_tpu/models/network_utils.py``, every encoding of its
factory: ``CP`` and ``HashGrid`` (each with its Jacobian path),
``ProgressiveBandHashGrid``, ``VectorMatrix`` / ``VM``, ``VanillaFrequency``
and ``SphericalHarmonics``. As in the JAX
package, every module is a static Python object with ``init(generator,
device) -> params`` and ``apply(params, x, step=None) -> out`` (``step``, a
Python int, drives the progressive level mask), and parameters are nested dicts
keyed like the JAX pytree (``cp.line_{s}_{ax}``, ``layers[i].w``), so weights
carry across as copies (``utils/transplant.py``).

Training hands the tree's leaves to the optimizer: :func:`named_leaves`
lists them in the JAX package's flatten order and :func:`make_trainable`
turns them into leaf tensors that require grad. Gradients reach every leaf
through the fused ops' autograd Functions (``ops/cp_mlp.py``,
``ops/sh_mlp.py``) or, on the composed paths, through plain PyTorch ops.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from instant_nsr_pl_tpu_torch.ops.activations import elementwise_jvp, get_activation
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_encode, cp_encode_with_jac, cp_init
from instant_nsr_pl_tpu_torch.ops.cp_mlp import (
    check_fused_instantiated,
    cp_mlp_forward,
    cp_mlp_stacked_forward,
    fusable,
    fusable_stacked,
)
from instant_nsr_pl_tpu_torch.ops.cp_product import (
    JAC_BASIS_SHAPES,
    PRODUCT_COMPONENTS,
    SUPPORTED_JAC,
    SUPPORTED_PRODUCT,
)
from instant_nsr_pl_tpu_torch.ops.cp_stacked import STACKED_JAC_SHAPES
from instant_nsr_pl_tpu_torch.ops.cp_stacked import SUPPORTED as SUPPORTED_STACKED_JAC
from instant_nsr_pl_tpu_torch.ops.cp_stacked import stackable
from instant_nsr_pl_tpu_torch.ops.hashgrid import (
    HashGridSpec,
    hashgrid_encode,
    hashgrid_encode_fast,
    hashgrid_encode_with_jac,
    hashgrid_init,
)
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_apply, mlp_apply_jvp, mlp_init
from instant_nsr_pl_tpu_torch.ops.sh import sh_output_dim, spherical_harmonics_encoding
from instant_nsr_pl_tpu_torch.ops.vm import VMSpec, vm_encode, vm_encode_fast, vm_init
from instant_nsr_pl_tpu_torch.ops.vm import check_instantiated as check_vm_instantiated


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


def params_device(tree) -> torch.device:
    """The device a parameter tree lies on (its first leaf's)."""
    return named_leaves(tree)[0][1].device


def on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def make_trainable(tree):
    """Make every parameter of ``tree`` require grad, in place (the init
    draws them as leaf tensors); returns the tree."""
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    return tree


class VanillaFrequency:
    """sin / cos frequency bands ``2^i`` with the optional coarse-to-fine
    cosine mask of ``n_masking_step`` (JAX ``models/network_utils.py:29-58``,
    reference models/network_utils.py:14-37). The mask is a function of the
    Python-int training ``step``; without a step, or with no masking, every
    band is on. Plain PyTorch, as the JAX package computes it in XLA."""

    def __init__(self, in_channels, config):
        self.n_frequencies = int(config["n_frequencies"])
        self.n_input_dims = in_channels
        self.n_output_dims = in_channels * 2 * self.n_frequencies
        self.n_masking_step = int(config.get("n_masking_step", 0))
        self.freq_bands = tuple(2.0**i for i in range(self.n_frequencies))

    def init(self, generator, device=None):
        return {}

    def mask(self, step, device=None):
        """(n_frequencies,) float32: band i gets ``(1 - cos(pi * clip(step /
        n_masking_step * n - i, 0, 1))) / 2``."""
        n = self.n_frequencies
        if self.n_masking_step <= 0 or step is None:
            return torch.ones((n,), dtype=torch.float32, device=device)
        t = torch.tensor(float(step), dtype=torch.float32) / float(self.n_masking_step) * n
        x = torch.clamp(t - torch.arange(n, dtype=torch.float32), 0.0, 1.0)
        return ((1.0 - torch.cos(math.pi * x)) / 2.0).to(device)

    def apply(self, params, x, step=None):
        mask = self.mask(step, x.device)
        out = []
        for i, freq in enumerate(self.freq_bands):
            for fn in (torch.sin, torch.cos):
                out.append(fn(freq * x) * mask[i])
        return torch.cat(out, dim=-1)


class VectorMatrixEncoding:
    """TensoRF-style VM factorized encoding (``ops/vm.py``; JAX
    ``models/network_utils.py:170-200``). ``grad_mode`` ('fast' by
    default): 'fast' runs ``vm_encode_fast`` (VM1 forward and VM2 table
    gradient on the card, their plain versions on the CPU), first order;
    'autodiff' the composed ``vm_encode``, differentiable at any order (the
    NeuS analytic gradient switches to it: VM has no Jacobian path). The JAX
    package defaults to 'autodiff' off the TPU; both modes compute the same
    function. Parameters: ``{"vm": {plane_{s}_{k}, line_{s}_{k}}}``."""

    def __init__(self, in_channels, config):
        if in_channels != 3:
            raise ValueError("VM encoding is 3-D")
        self.spec = VMSpec.from_config(config)
        self.n_input_dims = 3
        self.n_output_dims = self.spec.n_output_dims
        self.grad_mode = str(config.get("grad_mode", "fast"))
        if self.grad_mode not in ("fast", "autodiff"):
            raise ValueError(f"VM grad_mode must be 'fast' or 'autodiff', got {self.grad_mode}")

    def init(self, generator, device=None):
        """The tables on ``device``; for the card, VM1 / VM2 must exist at
        the spec's width (the 'fast' mode), else ValueError."""
        if on_cuda(device) and self.grad_mode == "fast":
            check_vm_instantiated(self.spec)
        return {"vm": vm_init(generator, self.spec, device)}

    def apply(self, params, x, step=None):
        if self.grad_mode == "fast":
            return vm_encode_fast(params["vm"], x, self.spec)
        return vm_encode(params["vm"], x, self.spec)


class CPEncoding:
    """CP (line-factorized) encoding (``ops/cp.py``). The fused density op
    (``ops/cp_mlp.py``) takes over inside :class:`EncodingWithNetwork` when
    the pair is fusable.

    ``grad_mode`` ('fast' by default, the kernel path): 'fast' runs the CP
    product op (``ops/cp_product.py``: K5/K6 on the card) and, for
    :meth:`apply_with_jac`, the product-with-Jacobian op (K9/K10 with a
    basis, K7/K8 for the raw products, ``n_features: 0``); 'autodiff'
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

    def check_instantiated(self, jac=False):
        """Raise a ValueError unless the kernels this encoding launches in
        ``grad_mode: fast`` exist at its shape: the CP product (K5/K6) or,
        with ``jac``, the product with its Jacobian (K9/K10; K7/K8 for the
        raw products; K11/K12 with ``stack_scales``). Models built for the
        card call it, so a shape without kernels is refused at build time."""
        if self.grad_mode != "fast":
            return
        c, f, s_count = (self.spec.n_components, self.spec.n_features,
                         len(self.spec.resolutions))
        if not jac:
            ok, name, supported = c in PRODUCT_COMPONENTS, "cp_product", SUPPORTED_PRODUCT
        elif self.stack_scales:
            ok, name, supported = ((c, f, s_count) in STACKED_JAC_SHAPES,
                                   "cp_jac_basis_stacked", SUPPORTED_STACKED_JAC)
        elif f == 0:
            ok, name, supported = c in PRODUCT_COMPONENTS, "cp_product_jac", SUPPORTED_PRODUCT
        else:
            ok, name, supported = ((c, f) in JAC_BASIS_SHAPES, "cp_product_jac_basis",
                                   SUPPORTED_JAC)
        if not ok:
            raise ValueError(f"{name}: no CUDA instantiation for {self.spec}; "
                             f"supported: {supported}")

    def _impl(self):
        return "fast" if self.grad_mode == "fast" else "xla"

    def apply(self, params, x, step=None):
        return cp_encode(params["cp"], x, self.spec, impl=self._impl())

    def apply_with_jac(self, params, x, step=None):
        """(feat (..., E), d feat / d x (3, ..., E)) from one product-with-
        Jacobian op per scale, or one for all scales with ``stack_scales``
        (``ops/cp.py`` ``cp_encode_with_jac``)."""
        impl = self._impl()
        return cp_encode_with_jac(params["cp"], x, self.spec, impl=impl,
                                  stacked=self.stack_scales and impl == "fast")


class HashGridEncoding:
    """Multiresolution hash grid (tcnn ``HashGrid`` role, ``ops/hashgrid.py``).

    ``grad_mode`` ('fast' by default): 'fast' runs ``hashgrid_encode_fast``
    (HG1 forward and HG2 table gradient on the card, their plain versions on
    the CPU), first order; 'autodiff' the plain ``hashgrid_encode``,
    differentiable at any order. The JAX package defaults to 'autodiff' off
    the TPU; both modes compute the same function. :meth:`apply_with_jac`
    (the NeuS SDF's analytic gradient) runs ``hashgrid_encode_with_jac`` (HG3
    forward, HG4 backward) in either mode.

    ``configure_dedup`` keeps the per-group tap dedup spec (set by the
    renderer when its march guarantees aligned blocks, as in the JAX
    package): a ``grouped`` call of whole blocks then reads its coarse levels
    from one 27-point lattice per block (HG5 / HG6, and HG7 / HG8 on the jac
    path), the same function as the per-sample taps."""

    def __init__(self, in_channels, config):
        self.spec = HashGridSpec.from_config(config, n_input_dims=in_channels)
        self.n_input_dims = in_channels
        self.n_output_dims = self.spec.n_output_dims
        self.grad_mode = str(config.get("grad_mode", "fast"))
        if self.grad_mode not in ("fast", "autodiff"):
            raise ValueError(f"HashGrid grad_mode must be 'fast' or 'autodiff', got "
                             f"{self.grad_mode}")
        self.dedup_spec = None

    def configure_dedup(self, group: int, step: float):
        """Keep the dedup spec for ``grouped`` calls: ``group`` is the
        march's aligned block size, ``step`` the per-axis position step bound
        in [0, 1] coordinates (JAX ``HashGridEncoding.configure_dedup``)."""
        if group < 4 or step <= 0.0 or self.grad_mode != "fast":
            return
        spec = dataclasses.replace(self.spec, dedup_group=int(group), dedup_step=float(step))
        if any(spec.dedup_group_sizes):
            self.dedup_spec = spec

    def _spec_for(self, x, grouped):
        """The dedup spec when the caller guarantees aligned blocks and the
        flattened batch divides the block size, else the plain spec."""
        if grouped and self.dedup_spec is not None:
            if math.prod(x.shape[:-1]) % self.dedup_spec.dedup_group == 0:
                return self.dedup_spec
        return self.spec

    def init(self, generator, device=None):
        return {"table": hashgrid_init(generator, self.spec, device)}

    def _encode(self, table, x, level_mask=None, grouped=False):
        if self.grad_mode == "fast":
            return hashgrid_encode_fast(table, x, self._spec_for(x, grouped), level_mask)
        return hashgrid_encode(table, x, self.spec, level_mask)

    def _mask(self, step, device):
        """The level mask at ``step``: none for a plain hash grid."""
        return None

    def apply(self, params, x, step=None, grouped=False):
        table = params["table"]
        return self._encode(table, x, self._mask(step, table.device), grouped)

    def apply_with_jac(self, params, x, step=None, grouped=False):
        """(feat (..., L*F), jac (3, ..., L*F)): the features and their
        analytic position Jacobian from one set of taps
        (``hashgrid_encode_with_jac``), with the dedup spec for a ``grouped``
        call of whole blocks (JAX ``models/network_utils.py:126-134,
        165-170``)."""
        table = params["table"]
        return hashgrid_encode_with_jac(table, x, self._spec_for(x, grouped),
                                        self._mask(step, table.device))


class ProgressiveBandHashGrid(HashGridEncoding):
    """Neuralangelo's progressive level unmasking (JAX
    ``models/network_utils.py:137-170``, reference models/network_utils.py:
    40-65): levels at or above :meth:`current_level` are zeroed, and the
    level advances every ``update_steps`` after ``start_step``. The mask is
    built from a Python int step, as an (L,) float32 tensor on the table's
    device (kept once per level and device); the kernels take it as their
    level mask (HG1/HG2, HG3/HG4)."""

    def __init__(self, in_channels, config):
        super().__init__(in_channels, config)
        self.start_level = int(config["start_level"])
        self.start_step = int(config["start_step"])
        self.update_steps = int(config["update_steps"])
        self._masks = {}

    def current_level(self, step):
        """The number of unmasked levels at ``step`` (all for None)."""
        if step is None:
            return self.spec.n_levels
        lvl = self.start_level + max(int(step) - self.start_step, 0) // self.update_steps
        return min(lvl, self.spec.n_levels)

    def _mask(self, step, device):
        if step is None:
            return None
        key = (self.current_level(step), torch.device(device))
        mask = self._masks.get(key)
        if mask is None:
            mask = (torch.arange(self.spec.n_levels) < key[0]).float().to(key[1])
            self._masks[key] = mask
        return mask


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

    def apply(self, params, x, step=None):
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

    def apply(self, params, x, step=None, grouped=False):
        kw = {"grouped": True} if grouped and self.dedup_spec is not None else {}
        enc = self.encoding.apply(params, x, step=step, **kw)
        if not self.include_xyz:
            return enc
        return torch.cat([x * self.xyz_scale + self.xyz_offset, enc], dim=-1)

    @property
    def dedup_spec(self):
        return getattr(self.encoding, "dedup_spec", None)

    def configure_dedup(self, group: int, step: float):
        fn = getattr(self.encoding, "configure_dedup", None)
        if fn is not None:
            fn(group, step)

    @property
    def has_jac(self) -> bool:
        return hasattr(self.encoding, "apply_with_jac")

    def apply_with_jac(self, params, x, step=None, grouped=False):
        """(feat (..., D), jac (3, ..., D)) including the identity block of
        the prepended xyz channels (d(x * s + o)/dx = s * I); ``grouped`` as
        in :meth:`apply`."""
        kw = {"grouped": True} if grouped and self.dedup_spec is not None else {}
        enc, jac = self.encoding.apply_with_jac(params, x, step=step, **kw)
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
    elif otype == "HashGrid":
        enc = HashGridEncoding(n_input_dims, config)
    elif otype == "ProgressiveBandHashGrid":
        enc = ProgressiveBandHashGrid(n_input_dims, config)
    elif otype == "SphericalHarmonics":
        enc = SphericalHarmonicsEncoding(n_input_dims, config)
    elif otype == "VanillaFrequency":
        enc = VanillaFrequency(n_input_dims, config)
    elif otype in ("VectorMatrix", "VM"):
        enc = VectorMatrixEncoding(n_input_dims, config)
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
        """Parameters on ``device``. For the card, the kernels of the route
        (fused or composed) must exist at the CP shape, else ValueError."""
        inner = self.encoding.encoding
        if on_cuda(device) and self.fused:
            check_fused_instantiated(inner.spec, self.network.spec, inner.stack_scales)
        elif on_cuda(device) and isinstance(inner, CPEncoding):
            inner.check_instantiated()
        return {
            "encoding": self.encoding.init(generator, device),
            "network": self.network.init(generator, device),
        }

    def apply(self, params, x, step=None, grouped=False):
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
            params["network"],
            self.encoding.apply(params["encoding"], x, step=step, grouped=grouped),
        )


def get_encoding_with_network(n_input_dims, n_output_dims, encoding_config, network_config):
    encoding = get_encoding(n_input_dims, encoding_config)
    network = get_mlp(encoding.n_output_dims, n_output_dims, network_config)
    return EncodingWithNetwork(encoding, network)
