"""Fused CP-encode -> basis -> bf16 ReLU MLP (the density head), forward and
backward.

Port of ``instant_nsr_pl_tpu/ops/cp_mlp_pallas.py`` ``cp_mlp_apply`` and its
custom VJP. On CUDA tensors the op launches the hand-written kernels
``csrc/cp_mlp_fwd.cu`` (K1) and, in its backward, ``csrc/cp_mlp_bwd.cu``
(K2); on CPU tensors it runs the plain PyTorch versions below, which follow
the TPU kernels' rounding points. There is no fallback from one to the other.

Precision contract (the TPU kernel's): bf16 line tables, basis and MLP
weights; each tent weight rounded to bf16; the f32 axis product rounded to
bf16 before the basis projection; then the bf16 MLP chain of ``ops/mlp.py``.
The backward reads the forward's bf16 residuals (``vsave``: the interpolated
line values, ``hsave``: the hidden activations) and rounds every matmul
operand (activations, cotangents, ``d_enc``, ``prod``, ``d_v``) to bf16 with
f32 sums.

Differentiable with respect to the CP and MLP parameters only: positions get
no cotangent (``cp_mlp_pallas.py:24-30``; they are march outputs).

``cp_mlp_stacked_forward`` is the stacked-scales twin (``cp_mlp_apply_stacked``,
``cp_mlp_pallas.py:425-646``): with nested resolutions every scale is
upsampled onto the finest grid (``ops/cp_stacked.py``), so one tent per axis
serves all scales and the basis is block-diagonal. On CUDA tensors it
launches K13 and K14 (``cp_mlp_stacked_fwd`` / ``cp_mlp_stacked_bwd`` of the
same sources), on CPU tensors the plain versions, which run the per-scale
plain versions on the fine table as one scale of S*C components with the
(S*C, E) block-diagonal basis.
"""

from __future__ import annotations

import ctypes

import torch

from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec
from instant_nsr_pl_tpu_torch.ops.cp_product import tent_coords
from instant_nsr_pl_tpu_torch.ops.cp_stacked import (
    basis_stack,
    blockdiag_bt,
    coarse_line_grads,
    cp_from_leaves,
    cp_leaves,
    diagonal_blocks,
    stack_lines_fine,
    stackable,
)
from instant_nsr_pl_tpu_torch.ops.mlp import bf16_round, mlp_apply
from instant_nsr_pl_tpu_torch.ops.mlp_common import (
    mlp_backward_plain,
    mlp_wmax,
    pack_mlp,
    unpack_mlp_grads,
)

# the plain version interpolates at most this many samples at a time
_CHUNK = 1 << 18

# The (C, F, scales, width, hidden layers, D) shapes that csrc/cp_mlp_fwd.cu
# and csrc/cp_mlp_bwd.cu instantiate (K1/K2, and K13/K14 for the stacked
# list): the bench NeRF heads of bench.py --encoding cp / cp_big / cp_stacked
# and the small test models.
INSTANTIATIONS = (
    (64, 16, 2, 64, 1, 16),   # cp
    (128, 16, 3, 64, 1, 16),  # cp_big
    (16, 8, 2, 32, 1, 16),    # the small test models
    (16, 8, 2, 32, 2, 16),
)
STACKED_INSTANTIATIONS = (
    (64, 16, 2, 64, 1, 16),   # cp_stacked
    (16, 8, 2, 32, 1, 16),
    (16, 8, 2, 32, 2, 16),
)
SUPPORTED = f"(C, F, scales, width, hidden layers, D) in {INSTANTIATIONS}"
SUPPORTED_STACKED = f"(C, F, scales, width, hidden layers, D) in {STACKED_INSTANTIATIONS}"


def fused_shape(cp_spec: CPSpec, mlp_spec) -> tuple:
    """The (C, F, scales, width, hidden layers, D) key of the fused kernels."""
    return (cp_spec.n_components, cp_spec.n_features, len(cp_spec.resolutions),
            mlp_spec.n_neurons, mlp_spec.n_hidden_layers, mlp_spec.dim_out)


def check_fused_instantiated(cp_spec: CPSpec, mlp_spec, stacked=False):
    """Raise a ValueError unless the fused kernels of this route (K1/K2, or
    K13/K14 with ``stacked``) are instantiated at this shape: a model built
    for the card is refused when it is built, not at its first launch."""
    shapes = STACKED_INSTANTIATIONS if stacked else INSTANTIATIONS
    if fused_shape(cp_spec, mlp_spec) not in shapes:
        name = "cp_mlp_stacked_forward" if stacked else "cp_mlp_forward"
        raise ValueError(f"{name}: no CUDA instantiation for {fused_shape(cp_spec, mlp_spec)}; "
                         f"supported: {SUPPORTED_STACKED if stacked else SUPPORTED}")


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


def fusable_stacked(cp_spec: CPSpec, mlp_spec) -> bool:
    """Static check for the stacked-scales fused op: ``fusable`` and nested
    resolutions."""
    return fusable(cp_spec, mlp_spec) and stackable(cp_spec)


def cp_mlp_forward(cp_params, mlp_params, x, cp_spec: CPSpec, mlp_spec):
    """Fused (CP encode -> basis -> bf16 ReLU MLP)(x): (..., 3) -> (..., D)
    float32, with x in [0, 1]^3 (clipped). Callers satisfy
    ``fusable(cp_spec, mlp_spec)``.

    With grad mode on and a parameter that requires grad, the op records its
    backward: the forward then also writes the residuals (K1 training mode)
    and the backward runs K2 (or the plain versions, on CPU tensors)."""
    flat = _flat_params(cp_params, mlp_params, cp_spec)
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return _CPMLP.apply(x, cp_spec, mlp_spec, *flat)
    if x.device.type == "cuda":
        operands = cp_mlp_operands(cp_params, mlp_params, cp_spec, mlp_spec)
        return cp_mlp_launch(operands, x, cp_spec, mlp_spec)[0]
    if x.device.type == "cpu":
        return cp_mlp_forward_plain(cp_params, mlp_params, x, cp_spec, mlp_spec)
    raise ValueError(f"cp_mlp_forward: unsupported device {x.device}")


cp_mlp_forward.launches = 0


def _flat_params(cp_params, mlp_params, cp_spec):
    """The op's parameter tensors in a fixed order: line_{s}_{ax} for every
    scale and axis, basis_{s}, then each layer's w and b."""
    layers = [t for layer in mlp_params for t in (layer["w"], layer["b"])]
    return cp_leaves(cp_params, cp_spec) + layers


def _unflat_params(flat, cp_spec):
    s_count = len(cp_spec.resolutions)
    cp_params = cp_from_leaves(flat[:4 * s_count], cp_spec)
    rest = flat[4 * s_count:]
    mlp_params = [{"w": rest[k], "b": rest[k + 1]} for k in range(0, len(rest), 2)]
    return cp_params, mlp_params


class _CPMLP(torch.autograd.Function):
    """The op with its custom backward (``cp_mlp_apply``'s VJP). The bf16
    operands are packed once in the forward and handed to the backward."""

    @staticmethod
    def forward(ctx, x, cp_spec, mlp_spec, *flat):
        cp_params, mlp_params = _unflat_params(flat, cp_spec)
        operands = cp_mlp_operands(cp_params, mlp_params, cp_spec, mlp_spec)
        if x.device.type == "cuda":
            out, vsave, hsave = cp_mlp_launch(operands, x, cp_spec, mlp_spec, train=True)
        elif x.device.type == "cpu":
            out, vsave, hsave = cp_mlp_forward_plain(
                cp_params, mlp_params, x, cp_spec, mlp_spec, save_residuals=True
            )
        else:
            raise ValueError(f"cp_mlp_forward: unsupported device {x.device}")
        _, basis, ws, _ = operands
        ctx.save_for_backward(x, vsave, hsave, basis, ws)
        ctx.specs = (cp_spec, mlp_spec)
        ctx.layer_shapes = [tuple(layer["w"].shape) for layer in mlp_params]
        return out

    @staticmethod
    def backward(ctx, dout):
        x, vsave, hsave, basis, ws = ctx.saved_tensors
        cp_spec, mlp_spec = ctx.specs
        dlines, dbasis, dws, dbs = cp_mlp_backward(
            x, vsave, hsave, dout.contiguous(), basis, ws, cp_spec, mlp_spec
        )
        grads = [dlines[s][ax] for s in range(len(dlines)) for ax in range(3)]
        grads += list(dbasis)
        for layer in unpack_mlp_grads(dws, dbs, ctx.layer_shapes):
            grads += [layer["w"], layer["b"]]
        return (None, None, None, *grads)


def cp_mlp_backward(x, vsave, hsave, dout, basis, ws, cp_spec: CPSpec, mlp_spec):
    """The op's backward (K2): from the positions, the forward's residuals
    and the output cotangent (N, D), the gradients ``(dlines, dbasis, dws,
    dbs)``: per scale a (3, R_s, C) line-table gradient, the (S, C, F) basis
    gradient, and the packed MLP gradients (rows, Wmax) and (L, Wmax)."""
    if x.device.type == "cuda":
        return cp_mlp_backward_launch(x, vsave, hsave, dout, basis, ws, cp_spec, mlp_spec)
    if x.device.type == "cpu":
        return cp_mlp_backward_plain(x, vsave, hsave, dout, basis, ws, cp_spec, mlp_spec)
    raise ValueError(f"cp_mlp_backward: unsupported device {x.device}")


cp_mlp_backward.launches = 0


def _line_values(lines, u3, res):
    """The three (N, C) interpolated lines of one scale from its bf16-valued
    (R, C) tables: v = w0 * L[i0] + w1 * L[i0 + 1] with the bf16 tent weights
    of :func:`tent_coords`, both products exact in f32 and one rounding in
    the sum, as the kernel's fmaf and the TPU's tent matmul compute it."""
    vs = []
    for ax, line in enumerate(lines):
        i0, w0, w1, _ = tent_coords(u3[ax], res)
        v = torch.index_select(line, 0, i0).mul_(w0[:, None])
        vs.append(v.addcmul_(w1[:, None], torch.index_select(line, 0, i0 + 1)))
    return vs


def cp_mlp_forward_plain(cp_params, mlp_params, x, cp_spec: CPSpec, mlp_spec,
                         save_residuals=False):
    """Plain PyTorch version of the fused op with the kernel's precision
    contract (float32 matmuls on bf16-valued operands), interpolating in
    chunks of samples; chunking changes no value. With ``save_residuals``
    returns ``(out, vsave, hsave)``: the (3, S*C, N) bf16 line values and the
    (NH, W, N) bf16 hidden activations of K1's training mode."""
    xf = x.reshape(-1, 3).float()
    n = xf.shape[0]
    c = cp_spec.n_components
    s_count = len(cp_spec.resolutions)
    encs = []
    vsave = (torch.empty((3, s_count * c, n), dtype=torch.bfloat16, device=x.device)
             if save_residuals else None)
    for s, res in enumerate(cp_spec.resolutions):
        lines = [bf16_round(cp_params[f"line_{s}_{ax}"].float()) for ax in range(3)]
        basis = bf16_round(cp_params[f"basis_{s}"].float())
        enc = torch.empty((n, cp_spec.n_features), dtype=torch.float32, device=x.device)
        for start in range(0, n, _CHUNK):
            vs = _line_values(lines, xf[start:start + _CHUNK].T, res)
            if vsave is not None:
                for ax in range(3):
                    vsave[ax, s * c:(s + 1) * c, start:start + _CHUNK] = vs[ax].T
            enc[start:start + _CHUNK] = bf16_round((vs[0] * vs[1]) * vs[2]) @ basis
        encs.append(enc)
    hidden = [] if save_residuals else None
    out = mlp_apply(mlp_params, torch.cat(encs, dim=-1), mlp_spec, hidden=hidden)
    out = out.reshape(*x.shape[:-1], mlp_spec.dim_out)
    if not save_residuals:
        return out
    hsave = torch.stack([h.T for h in hidden]).to(torch.bfloat16).contiguous()
    return out, vsave, hsave


def cp_mlp_backward_plain(x, vsave, hsave, dout, basis, ws, cp_spec: CPSpec, mlp_spec):
    """Plain PyTorch version of K2 (``_bwd_kernel``) at the TPU kernel's
    rounding points, from the same residuals: returns ``(dlines, dbasis,
    dws, dbs)`` as :func:`cp_mlp_backward`. ``basis`` is the (S, C, F) bf16
    stack and ``ws`` the packed bf16 MLP of :func:`cp_mlp_operands`."""
    xf = x.reshape(-1, 3).float()
    n = xf.shape[0]
    c, f = cp_spec.n_components, cp_spec.n_features
    s_count = len(cp_spec.resolutions)
    v = vsave.float().reshape(3, s_count, c, n)
    prod = (v[0] * v[1]) * v[2]  # (S, C, N) f32 from the bf16 residuals
    prod_r = bf16_round(prod)
    bas = basis.float()  # (S, C, F)
    enc = torch.cat([prod_r[s].T @ bas[s] for s in range(s_count)], dim=-1)  # (N, E)
    acts = [enc] + [h.float().T for h in hsave]
    d_enc, dws, dbs = mlp_backward_plain(ws, acts, dout.reshape(n, mlp_spec.dim_out).float())
    d_enc_r = bf16_round(d_enc)
    dbasis = torch.stack([
        prod_r[s] @ d_enc_r[:, s * f:(s + 1) * f] for s in range(s_count)
    ])  # (S, C, F)
    dlines = []
    for s, res in enumerate(cp_spec.resolutions):
        d_prod = d_enc_r[:, s * f:(s + 1) * f] @ bas[s].T  # (N, C)
        vs = [v[ax, s].T for ax in range(3)]  # (N, C) each
        others = (vs[1] * vs[2], vs[0] * vs[2], vs[0] * vs[1])
        grad = torch.zeros((3, res, c), dtype=torch.float32, device=x.device)
        for ax in range(3):
            d_v = bf16_round(d_prod * others[ax])
            i0, w0, w1, _ = tent_coords(xf[:, ax], res)
            grad[ax].index_add_(0, i0, w0[:, None] * d_v)
            grad[ax].index_add_(0, i0 + 1, w1[:, None] * d_v)
        dlines.append(grad)
    return dlines, dbasis, dws, dbs


def cp_mlp_operands(cp_params, mlp_params, cp_spec: CPSpec, mlp_spec):
    """The kernels' device-layout operands: per-scale (3, R, C) bf16 line
    stacks (rows contiguous for the 2-row reads), the (S, C, F) bf16 basis
    and the packed MLP. Parameters that do not change between calls can be
    packed once and passed to :func:`cp_mlp_launch` directly."""
    if not fusable(cp_spec, mlp_spec):
        raise ValueError(f"cp_mlp_forward: not fusable: {cp_spec} {mlp_spec}")
    s_count = len(cp_spec.resolutions)
    with torch.no_grad():
        lines = [
            torch.stack([cp_params[f"line_{s}_{ax}"] for ax in range(3)])
            .to(torch.bfloat16).contiguous()
            for s in range(s_count)
        ]
        basis = torch.stack([cp_params[f"basis_{s}"] for s in range(s_count)])
        ws, bs = pack_mlp(mlp_params, mlp_wmax(mlp_spec))
    return lines, basis.to(torch.bfloat16).contiguous(), ws, bs


def cp_mlp_launch(operands, x, cp_spec: CPSpec, mlp_spec, train=False):
    """Launch ``csrc/cp_mlp_fwd.cu`` on packed ``operands`` for CUDA x.
    Returns ``(out, vsave, hsave)``; the residuals are written only with
    ``train`` (else None)."""
    lines, basis, ws, bs = operands
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"cp_mlp_forward: x must be (..., 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    s_count = len(cp_spec.resolutions)
    c, f = cp_spec.n_components, cp_spec.n_features
    w = mlp_wmax(mlp_spec)
    nh = mlp_spec.n_hidden_layers
    expect = [(3, r, c) for r in cp_spec.resolutions] + [
        (s_count, c, f), (mlp_spec.dim_in + nh * w, w), (nh + 1, w)]
    cuda_build.check_operands("cp_mlp_forward", (*lines, basis, ws, bs), expect, x.device)
    xf = x.reshape(-1, 3).contiguous()
    n = xf.shape[0]
    out = torch.empty((n, mlp_spec.dim_out), dtype=torch.float32, device=x.device)
    vsave = hsave = None
    if train:
        vsave = torch.empty((3, s_count * c, n), dtype=torch.bfloat16, device=x.device)
        hsave = torch.empty((nh, mlp_spec.n_neurons, n), dtype=torch.bfloat16, device=x.device)
    fn = cuda_build.library("cp_mlp_fwd").cp_mlp_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    line_ptrs = (ctypes.c_void_p * s_count)(*[t.data_ptr() for t in lines])
    res = (ctypes.c_int * s_count)(*cp_spec.resolutions)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            xf.data_ptr(), n, line_ptrs, res, s_count, basis.data_ptr(),
            ws.data_ptr(), bs.data_ptr(), out.data_ptr(), c, f,
            mlp_spec.n_neurons, nh, mlp_spec.dim_out,
            vsave.data_ptr() if train else None, hsave.data_ptr() if train else None,
            stream,
        )
    cuda_build.check(rc, "cp_mlp_forward", SUPPORTED)
    cp_mlp_forward.launches += 1
    return out.reshape(*x.shape[:-1], mlp_spec.dim_out), vsave, hsave


def _split_backward(out, rows, w, nh, s_count, c, f):
    """Views ``(dbasis, dws, dbs)`` of a backward entry point's summed
    output: dW (rows, W), db (NH + 1, W) and dbasis (S, C, F), in that order."""
    a, b = rows * w, rows * w + (nh + 1) * w
    return out[b:].view(s_count, c, f), out[:a].view(rows, w), out[a:b].view(nh + 1, w)


def cp_mlp_backward_launch(x, vsave, hsave, dout, basis, ws, cp_spec: CPSpec, mlp_spec):
    """Launch ``csrc/cp_mlp_bwd.cu`` (K2) for CUDA tensors; see
    :func:`cp_mlp_backward` for the outputs. dW, db and dbasis come from
    per-block partial sums added in block order by a second kernel; the line
    tables from atomics. With no samples it returns zeros and launches
    nothing."""
    s_count = len(cp_spec.resolutions)
    c, f = cp_spec.n_components, cp_spec.n_features
    w = mlp_wmax(mlp_spec)
    nh = mlp_spec.n_hidden_layers
    xf = x.reshape(-1, 3).contiguous()
    n = xf.shape[0]
    d = mlp_spec.dim_out
    if dout.dtype != torch.float32:
        raise ValueError(f"cp_mlp_backward: dout must be float32, got {dout.dtype}")
    dflat = dout.reshape(n, d).contiguous()
    expect = [(3, s_count * c, n), (nh, mlp_spec.n_neurons, n), (n, d), (s_count, c, f),
              (mlp_spec.dim_in + nh * w, w)]
    cuda_build.check_operands("cp_mlp_backward", (vsave, hsave, dflat, basis, ws), expect, x.device)
    dev = x.device
    dlines = [torch.zeros((3, r, c), dtype=torch.float32, device=dev) for r in cp_spec.resolutions]
    rows = ws.shape[0]
    if n == 0:
        return (dlines, torch.zeros((s_count, c, f), dtype=torch.float32, device=dev),
                torch.zeros((rows, w), dtype=torch.float32, device=dev),
                torch.zeros((nh + 1, w), dtype=torch.float32, device=dev))
    fn = cuda_build.entry("cp_mlp_bwd", "cp_mlp_bwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    dline_ptrs = (ctypes.c_void_p * s_count)(*[t.data_ptr() for t in dlines])
    res = (ctypes.c_int * s_count)(*cp_spec.resolutions)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(part, blocks, out, info, n_):
            return fn(xf.data_ptr(), n_, vsave.data_ptr(), hsave.data_ptr(), dflat.data_ptr(),
                      basis.data_ptr(), ws.data_ptr(), dline_ptrs, res, s_count, part, blocks,
                      out, info, c, f, mlp_spec.n_neurons, nh, d, stream)

        out = cuda_build.launch_persistent(("cp_mlp_bwd", *fused_shape(cp_spec, mlp_spec),
                                            dev.index), call, n, dev, "cp_mlp_backward", SUPPORTED)
    dbasis, dws, dbs = _split_backward(out, rows, w, nh, s_count, c, f)
    cp_mlp_backward.launches += 1
    return dlines, dbasis, dws, dbs


# ---------------------------------------------------------------------------
# the stacked-scales op (K13 forward, K14 backward)
# ---------------------------------------------------------------------------


def cp_mlp_stacked_forward(cp_params, mlp_params, x, cp_spec: CPSpec, mlp_spec):
    """The fused op with all scales on the finest grid (``cp_mlp_apply_stacked``):
    the same contract as :func:`cp_mlp_forward`. Callers satisfy
    ``fusable_stacked(cp_spec, mlp_spec)``."""
    flat = _flat_params(cp_params, mlp_params, cp_spec)
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return _CPMLPStacked.apply(x, cp_spec, mlp_spec, *flat)
    if x.device.type == "cuda":
        operands = cp_mlp_stacked_operands(cp_params, mlp_params, cp_spec, mlp_spec)
        return cp_mlp_stacked_launch(operands, x, cp_spec, mlp_spec)[0]
    if x.device.type == "cpu":
        return cp_mlp_stacked_forward_plain(cp_params, mlp_params, x, cp_spec, mlp_spec)
    raise ValueError(f"cp_mlp_stacked_forward: unsupported device {x.device}")


cp_mlp_stacked_forward.launches = 0


class _CPMLPStacked(torch.autograd.Function):
    """The stacked op with its custom backward (``cp_mlp_apply_stacked``'s
    VJP): K14's fine-table gradient goes back to each scale as U^T d fine."""

    @staticmethod
    def forward(ctx, x, cp_spec, mlp_spec, *flat):
        cp_params, mlp_params = _unflat_params(flat, cp_spec)
        operands = cp_mlp_stacked_operands(cp_params, mlp_params, cp_spec, mlp_spec)
        if x.device.type == "cuda":
            out, vsave, hsave = cp_mlp_stacked_launch(operands, x, cp_spec, mlp_spec, train=True)
        elif x.device.type == "cpu":
            out, vsave, hsave = cp_mlp_stacked_forward_plain(
                cp_params, mlp_params, x, cp_spec, mlp_spec, save_residuals=True)
        else:
            raise ValueError(f"cp_mlp_stacked_forward: unsupported device {x.device}")
        _, basis, ws, _ = operands
        ctx.save_for_backward(x, vsave, hsave, basis, ws)
        ctx.specs = (cp_spec, mlp_spec)
        ctx.layer_shapes = [tuple(layer["w"].shape) for layer in mlp_params]
        return out

    @staticmethod
    def backward(ctx, dout):
        x, vsave, hsave, basis, ws = ctx.saved_tensors
        cp_spec, mlp_spec = ctx.specs
        dfine, dbasis, dws, dbs = cp_mlp_stacked_backward(
            x, vsave, hsave, dout.contiguous(), basis, ws, cp_spec, mlp_spec)
        lines = coarse_line_grads(dfine, cp_spec)
        s_count = len(cp_spec.resolutions)
        grads = [lines[f"line_{s}_{ax}"] for s in range(s_count) for ax in range(3)]
        grads += list(dbasis)
        for layer in unpack_mlp_grads(dws, dbs, ctx.layer_shapes):
            grads += [layer["w"], layer["b"]]
        return (None, None, None, *grads)


def cp_mlp_stacked_backward(x, vsave, hsave, dout, basis, ws, cp_spec: CPSpec, mlp_spec):
    """The stacked op's backward (K14): ``(dfine, dbasis, dws, dbs)``: the
    (3, R_max, S*C) fine-table gradient, the (S, C, F) basis gradient and
    the packed MLP gradients."""
    if x.device.type == "cuda":
        return cp_mlp_stacked_backward_launch(x, vsave, hsave, dout, basis, ws, cp_spec,
                                              mlp_spec)
    if x.device.type == "cpu":
        return cp_mlp_stacked_backward_plain(x, vsave, hsave, dout, basis, ws, cp_spec,
                                             mlp_spec)
    raise ValueError(f"cp_mlp_stacked_backward: unsupported device {x.device}")


cp_mlp_stacked_backward.launches = 0


def _fine_spec(cp_spec: CPSpec) -> CPSpec:
    """The stacked table seen as one scale of S*C components at R_max,
    projected by the (S*C, E) block-diagonal basis."""
    s_count = len(cp_spec.resolutions)
    return CPSpec(n_components=s_count * cp_spec.n_components,
                  resolutions=(max(cp_spec.resolutions),), n_features=cp_spec.n_output_dims)


def cp_mlp_stacked_forward_plain(cp_params, mlp_params, x, cp_spec: CPSpec, mlp_spec,
                                 save_residuals=False):
    """Plain PyTorch version of K13 (``_fwd_kernel_stacked``): the per-scale
    plain version on the fine table of :func:`stack_lines_fine` (one tent per
    axis at R_max for all S*C components) with the block-diagonal basis, as
    the TPU's full-width products. Returns what :func:`cp_mlp_forward_plain`
    does; vsave is the (3, S*C, N) bf16 residual of K13's training mode."""
    lines = stack_lines_fine(cp_params, cp_spec)
    fine = {f"line_0_{ax}": lines[ax].float() for ax in range(3)}
    fine["basis_0"] = blockdiag_bt(basis_stack(cp_params, cp_spec)).T.float()
    return cp_mlp_forward_plain(fine, mlp_params, x, _fine_spec(cp_spec), mlp_spec,
                                save_residuals=save_residuals)


def cp_mlp_stacked_backward_plain(x, vsave, hsave, dout, basis, ws, cp_spec: CPSpec,
                                  mlp_spec):
    """Plain PyTorch version of K14 (``_bwd_kernel_stacked``): the per-scale
    plain backward on the fine table with the block-diagonal basis, then the
    diagonal (C, F) blocks of its (S*C, E) basis gradient, as the JAX package
    slices them. Returns ``(dfine, dbasis, dws, dbs)``."""
    bt = blockdiag_bt(basis).T[None].contiguous()  # (1, S*C, E)
    (dfine,), dbt, dws, dbs = cp_mlp_backward_plain(x, vsave, hsave, dout, bt, ws,
                                                    _fine_spec(cp_spec), mlp_spec)
    return dfine, diagonal_blocks(dbt[0], len(cp_spec.resolutions)), dws, dbs


def cp_mlp_stacked_operands(cp_params, mlp_params, cp_spec: CPSpec, mlp_spec):
    """The stacked kernels' operands: the (3, R_max, S*C) bf16 fine table,
    the (S, C, F) bf16 diagonal basis blocks and the packed MLP."""
    if not fusable_stacked(cp_spec, mlp_spec):
        raise ValueError(f"cp_mlp_stacked_forward: not fusable: {cp_spec} {mlp_spec}")
    with torch.no_grad():
        ws, bs = pack_mlp(mlp_params, mlp_wmax(mlp_spec))
    return stack_lines_fine(cp_params, cp_spec), basis_stack(cp_params, cp_spec), ws, bs


def cp_mlp_stacked_launch(operands, x, cp_spec: CPSpec, mlp_spec, train=False):
    """Launch K13 (``cp_mlp_stacked_fwd`` of ``csrc/cp_mlp_fwd.cu``) on the
    stacked ``operands`` for CUDA x. Returns ``(out, vsave, hsave)``; the
    residuals only with ``train`` (else None)."""
    lines, basis, ws, bs = operands
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"cp_mlp_stacked_forward: x must be (..., 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    s_count = len(cp_spec.resolutions)
    c, f = cp_spec.n_components, cp_spec.n_features
    rmax = max(cp_spec.resolutions)
    w = mlp_wmax(mlp_spec)
    nh = mlp_spec.n_hidden_layers
    expect = [(3, rmax, s_count * c), (s_count, c, f), (mlp_spec.dim_in + nh * w, w),
              (nh + 1, w)]
    cuda_build.check_operands("cp_mlp_stacked_forward", (lines, basis, ws, bs), expect,
                              x.device)
    xf = x.reshape(-1, 3).contiguous()
    n = xf.shape[0]
    out = torch.empty((n, mlp_spec.dim_out), dtype=torch.float32, device=x.device)
    vsave = hsave = None
    if train:
        vsave = torch.empty((3, s_count * c, n), dtype=torch.bfloat16, device=x.device)
        hsave = torch.empty((nh, mlp_spec.n_neurons, n), dtype=torch.bfloat16, device=x.device)
    fn = cuda_build.library("cp_mlp_fwd").cp_mlp_stacked_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            xf.data_ptr(), n, lines.data_ptr(), rmax, s_count, basis.data_ptr(),
            ws.data_ptr(), bs.data_ptr(), out.data_ptr(), c, f, mlp_spec.n_neurons, nh,
            mlp_spec.dim_out, vsave.data_ptr() if train else None,
            hsave.data_ptr() if train else None, stream,
        )
    cuda_build.check(rc, "cp_mlp_stacked_forward", SUPPORTED_STACKED)
    cp_mlp_stacked_forward.launches += 1
    return out.reshape(*x.shape[:-1], mlp_spec.dim_out), vsave, hsave


def cp_mlp_stacked_backward_launch(x, vsave, hsave, dout, basis, ws, cp_spec: CPSpec,
                                   mlp_spec):
    """Launch K14 (``cp_mlp_stacked_bwd`` of ``csrc/cp_mlp_bwd.cu``); see
    :func:`cp_mlp_stacked_backward` for the outputs. With no samples it
    returns zeros and launches nothing."""
    s_count = len(cp_spec.resolutions)
    c, f = cp_spec.n_components, cp_spec.n_features
    rmax = max(cp_spec.resolutions)
    w = mlp_wmax(mlp_spec)
    nh = mlp_spec.n_hidden_layers
    xf = x.reshape(-1, 3).contiguous()
    n = xf.shape[0]
    d = mlp_spec.dim_out
    if dout.dtype != torch.float32:
        raise ValueError(f"cp_mlp_stacked_backward: dout must be float32, got {dout.dtype}")
    dflat = dout.reshape(n, d).contiguous()
    expect = [(3, s_count * c, n), (nh, mlp_spec.n_neurons, n), (n, d), (s_count, c, f),
              (mlp_spec.dim_in + nh * w, w)]
    cuda_build.check_operands("cp_mlp_stacked_backward", (vsave, hsave, dflat, basis, ws),
                              expect, x.device)
    dev = x.device
    dfine = torch.zeros((3, rmax, s_count * c), dtype=torch.float32, device=dev)
    rows = ws.shape[0]
    if n == 0:
        return (dfine, torch.zeros((s_count, c, f), dtype=torch.float32, device=dev),
                torch.zeros((rows, w), dtype=torch.float32, device=dev),
                torch.zeros((nh + 1, w), dtype=torch.float32, device=dev))
    fn = cuda_build.entry("cp_mlp_bwd", "cp_mlp_stacked_bwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(part, blocks, out, info, n_):
            return fn(xf.data_ptr(), n_, vsave.data_ptr(), hsave.data_ptr(), dflat.data_ptr(),
                      basis.data_ptr(), ws.data_ptr(), dfine.data_ptr(), rmax, s_count, part,
                      blocks, out, info, c, f, mlp_spec.n_neurons, nh, d, stream)

        out = cuda_build.launch_persistent(("cp_mlp_stacked_bwd", *fused_shape(cp_spec, mlp_spec),
                                            dev.index), call, n, dev, "cp_mlp_stacked_backward",
                                           SUPPORTED_STACKED)
    dbasis, dws, dbs = _split_backward(out, rows, w, nh, s_count, c, f)
    cp_mlp_stacked_backward.launches += 1
    return dfine, dbasis, dws, dbs
