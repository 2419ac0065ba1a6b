"""Fused CP-encode -> basis -> bf16 ReLU MLP forward (the density head).

Port of ``instant_nsr_pl_tpu/ops/cp_mlp_pallas.py`` ``cp_mlp_apply``,
forward only. On a CUDA tensor the op launches the hand-written kernel
``csrc/cp_mlp_fwd.cu``; on a CPU tensor it runs the plain PyTorch version
below, which mirrors ``cp_mlp_reference`` (bf16 tent interpolation weights).
There is no fallback from one to the other.

Precision contract (the TPU kernel's): bf16 line tables, basis and MLP
weights; each tent weight rounded to bf16; the f32 axis product rounded to
bf16 before the basis projection; then the bf16 MLP chain of ``ops/mlp.py``.
"""

from __future__ import annotations

import ctypes

import torch

from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec
from instant_nsr_pl_tpu_torch.ops.mlp import bf16_round, mlp_apply
from instant_nsr_pl_tpu_torch.ops.mlp_common import mlp_wmax, pack_mlp

# tent operands of the plain version are built for at most this many
# (sample, grid-row) entries at a time: 2^26 f32 = 256 MB per temporary
_TENT_ELEMS = 1 << 26

SUPPORTED = ("(C, F, scales, width, hidden layers, D) in "
             "{(64, 16, 2, 64, 1, 16), (16, 8, 2, 32, 1|2, 16)}")


def fusable(cp_spec: CPSpec, mlp_spec) -> bool:
    """Static check: can this (encoding, MLP) pair run in the fused op?"""
    dims_ok = (
        cp_spec.n_components % 8 == 0
        and all(r >= 2 for r in cp_spec.resolutions)
        and cp_spec.n_features > 0
        and cp_spec.n_features % 8 == 0
        and mlp_spec.n_neurons % 8 == 0
        and mlp_spec.dim_out % 8 == 0
        and mlp_spec.dim_in == cp_spec.n_output_dims
        and mlp_spec.dim_out <= mlp_spec.n_neurons  # packed-width invariant
    )
    mlp_ok = (
        mlp_spec.activation.lower() == "relu"
        and mlp_spec.precision == "bf16"
        and not mlp_spec.weight_norm
        and not mlp_spec.sphere_init
        and mlp_spec.n_hidden_layers >= 1
    )
    return dims_ok and mlp_ok


def cp_mlp_forward(cp_params, mlp_params, x, cp_spec: CPSpec, mlp_spec):
    """Fused (CP encode -> basis -> bf16 ReLU MLP)(x): (..., 3) -> (..., D)
    float32, with x in [0, 1]^3 (clipped). Callers satisfy
    ``fusable(cp_spec, mlp_spec)``."""
    if x.device.type == "cuda":
        operands = cp_mlp_operands(cp_params, mlp_params, cp_spec, mlp_spec)
        return cp_mlp_launch(operands, x, cp_spec, mlp_spec)
    if x.device.type == "cpu":
        return cp_mlp_forward_plain(cp_params, mlp_params, x, cp_spec, mlp_spec)
    raise ValueError(f"cp_mlp_forward: unsupported device {x.device}")


cp_mlp_forward.launches = 0


def _tent_product(lines, u3, res):
    """(N, C) product over the three axes of bf16-tent interpolations:
    v = bf16(tent(p)) @ bf16(L), tent_r(p) = max(0, 1 - |r - p|)."""
    n = u3.shape[1]
    chunk = max(1, _TENT_ELEMS // res)
    iota = torch.arange(res, dtype=torch.float32, device=u3.device)[None, :]
    out = torch.empty((n, lines[0].shape[1]), dtype=torch.float32, device=u3.device)
    for start in range(0, n, chunk):
        prod = None
        for ax, line in enumerate(lines):
            p = torch.clamp(u3[ax, start:start + chunk], 0.0, 1.0) * (res - 1)
            w = bf16_round(torch.clamp(1.0 - (iota - p[:, None]).abs(), min=0.0))
            v = w @ bf16_round(line)
            prod = v if prod is None else prod * v
        out[start:start + chunk] = prod
    return out


def cp_mlp_forward_plain(cp_params, mlp_params, x, cp_spec: CPSpec, mlp_spec):
    """Plain PyTorch version of the fused op with the kernel's precision
    contract (float32 matmuls on bf16-valued operands). The dense tent
    operand is built in chunks of samples; chunking changes no value, since
    each row's tent has two non-zeros and the basis and MLP run on all
    samples at once."""
    xf = x.reshape(-1, 3).float()
    u3 = xf.T
    encs = []
    for s, r in enumerate(cp_spec.resolutions):
        lines = [cp_params[f"line_{s}_{ax}"] for ax in range(3)]
        prod = _tent_product(lines, u3, r)
        encs.append(bf16_round(prod) @ bf16_round(cp_params[f"basis_{s}"]))
    out = mlp_apply(mlp_params, torch.cat(encs, dim=-1), mlp_spec)
    return out.reshape(*x.shape[:-1], mlp_spec.dim_out)


def cp_mlp_operands(cp_params, mlp_params, cp_spec: CPSpec, mlp_spec):
    """The kernel's device-layout operands: per-scale (3, R, C) bf16 line
    stacks (rows contiguous for the 2-row reads), the (S, C, F) bf16 basis
    and the packed MLP. Parameters that do not change between calls can be
    packed once and passed to :func:`cp_mlp_launch` directly."""
    if not fusable(cp_spec, mlp_spec):
        raise ValueError(f"cp_mlp_forward: not fusable: {cp_spec} {mlp_spec}")
    s_count = len(cp_spec.resolutions)
    lines = [
        torch.stack([cp_params[f"line_{s}_{ax}"] for ax in range(3)])
        .to(torch.bfloat16).contiguous()
        for s in range(s_count)
    ]
    basis = torch.stack([cp_params[f"basis_{s}"] for s in range(s_count)])
    ws, bs = pack_mlp(mlp_params, mlp_wmax(mlp_spec))
    return lines, basis.to(torch.bfloat16).contiguous(), ws, bs


def cp_mlp_launch(operands, x, cp_spec: CPSpec, mlp_spec):
    """Launch ``csrc/cp_mlp_fwd.cu`` on packed ``operands`` for CUDA x."""
    lines, basis, ws, bs = operands
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"cp_mlp_forward: x must be (..., 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    s_count = len(cp_spec.resolutions)
    c, f = cp_spec.n_components, cp_spec.n_features
    w = mlp_wmax(mlp_spec)
    expect = [(3, r, c) for r in cp_spec.resolutions] + [
        (s_count, c, f), (mlp_spec.dim_in + mlp_spec.n_hidden_layers * w, w),
        (mlp_spec.n_hidden_layers + 1, w)]
    for t, shape in zip((*lines, basis, ws, bs), expect):
        if t.device != x.device or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"cp_mlp_forward: operand {tuple(t.shape)} on {t.device} "
                             f"does not match {shape} contiguous on {x.device}")
    xf = x.reshape(-1, 3).contiguous()
    n = xf.shape[0]
    out = torch.empty((n, mlp_spec.dim_out), dtype=torch.float32, device=x.device)
    fn = cuda_build.library("cp_mlp_fwd").cp_mlp_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    line_ptrs = (ctypes.c_void_p * s_count)(*[t.data_ptr() for t in lines])
    res = (ctypes.c_int * s_count)(*cp_spec.resolutions)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            xf.data_ptr(), n, line_ptrs, res, s_count, basis.data_ptr(),
            ws.data_ptr(), bs.data_ptr(), out.data_ptr(), c, f,
            mlp_spec.n_neurons, mlp_spec.n_hidden_layers, mlp_spec.dim_out, stream,
        )
    cuda_build.check(rc, "cp_mlp_forward", SUPPORTED)
    cp_mlp_forward.launches += 1
    return out.reshape(*x.shape[:-1], mlp_spec.dim_out)
