"""Stacked-scales CP encoding: every scale on the finest grid, and the CP
product with its Jacobian and the block-diagonal basis over all scales at once.

Port of ``instant_nsr_pl_tpu/ops/cp_pallas.py:709-993``: the helpers
``stackable``, ``_upsample_matrix``, ``_stack_lines_fine`` and
``_blockdiag_bt``, and ``cp_jac_basis_stacked`` with its custom VJP (K11
forward, K12 backward). On CUDA tensors the op launches the hand-written
kernels (``csrc/cp_jac_basis_fwd.cu`` ``cp_jac_stacked_fwd``,
``csrc/cp_jac_basis_bwd.cu`` ``cp_jac_stacked_bwd``); on CPU tensors it runs
the plain PyTorch versions below. There is no fallback from one to the other.

When every resolution is nested in the finest, ``(R_max - 1) % (R_s - 1) ==
0``, a coarse line is a piecewise-linear function whose knots are fine knots,
so it upsamples onto the fine grid exactly (``U @ line``, two non-zeros per row
of U). All scales then share one tent per axis, and their lines stack side by
side into one table. The port keeps that table row-major, (3, R_max, S*C) bf16,
so a sample reads two contiguous S*C-wide rows per axis (the JAX package's is
(3, S*C, R_max), laid out for the MXU). The gradient of the fine table goes
back to each coarse scale as ``U^T d fine``. Both products with U run outside
the kernels, as in the JAX package, and neither can take TF32: the upsample as
its two taps per fine row, ``a * L[j] + b * L[j+1]`` contracted into one fused
multiply-add, as the JAX package's f32 dot evaluates it on the CPU (bit-equal
bf16 tables at the bench shape); the gradient as a float64 product.

Precision contract: the one of ``ops/cp_product.py`` (K9/K10) on the fine
table, with the (E, S*C) block-diagonal basis. The kernels skip its zero
blocks; the plain versions run the TPU's full-width products.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops.cp_product import (
    _check_coords,
    cp_product_jac_basis_backward_plain,
    cp_product_jac_basis_plain,
)

# (C, F, scales) of K11/K12 (the stacked entry points of csrc/cp_jac_basis_*.cu)
STACKED_JAC_SHAPES = ((64, 16, 2), (16, 8, 2))
SUPPORTED = f"(C, F, scales) in {STACKED_JAC_SHAPES}, R_max >= 2"


# ---------------------------------------------------------------------------
# the stacked-scales helpers (cp_pallas.py:714-751, :869-879)
# ---------------------------------------------------------------------------


def stackable(cp_spec) -> bool:
    """True when every resolution is nested in the finest one."""
    rmax = max(cp_spec.resolutions)
    return all((rmax - 1) % (r - 1) == 0 for r in cp_spec.resolutions)


def upsample_matrix(r_coarse: int, r_fine: int) -> np.ndarray:
    """(r_fine, r_coarse) float32: the exact piecewise-linear interpolation
    of the coarse knots at the fine knots (weights 1 - m/k and m/k)."""
    k = (r_fine - 1) // (r_coarse - 1)
    u = np.zeros((r_fine, r_coarse), np.float32)
    for i in range(r_fine):
        j, m = divmod(i, k)
        if m == 0:
            u[i, j] = 1.0
        else:
            u[i, j] = 1.0 - m / k
            u[i, j + 1] = m / k
    return u


@functools.lru_cache(maxsize=16)
def _upsample(r_coarse: int, r_fine: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(upsample_matrix(r_coarse, r_fine)).double().to(device)


@functools.lru_cache(maxsize=16)
def _upsample_taps(r_coarse: int, r_fine: int, device: torch.device):
    """Per fine row i the two non-zeros of U: rows j and j1 of the coarse
    line with f32 weights a and b (j1 = j and b = 0 on a coarse knot)."""
    u = upsample_matrix(r_coarse, r_fine)
    k = (r_fine - 1) // (r_coarse - 1)
    i = np.arange(r_fine)
    j = i // k
    j1 = np.minimum(j + 1, r_coarse - 1)
    a, b = u[i, j], np.where(i % k == 0, np.float32(0.0), u[i, j1])
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in (j, j1, a, b))


def _upsample_line(line, r_fine):
    """U @ line (r_fine, C) in f32: round(b * L[j1] + round(a * L[j])), the
    fused multiply-add of an f32 dot that accumulates in row order."""
    j, j1, a, b = _upsample_taps(line.shape[0], r_fine, line.device)
    first = line[j] * a[:, None]  # rounded to f32
    return (line[j1].double() * b[:, None].double() + first.double()).float()


def stack_lines_fine(cp_params, cp_spec) -> torch.Tensor:
    """(3, R_max, S*C) bf16: every scale's (R_s, C) lines upsampled onto the
    finest grid, the scales side by side along the components."""
    rmax = max(cp_spec.resolutions)
    with torch.no_grad():
        per_ax = []
        for ax in range(3):
            cols = []
            for s, r in enumerate(cp_spec.resolutions):
                line = cp_params[f"line_{s}_{ax}"].float()
                if r != rmax:
                    line = _upsample_line(line, rmax)
                cols.append(line)
            per_ax.append(torch.cat(cols, dim=1))
        return torch.stack(per_ax).to(torch.bfloat16).contiguous()


def basis_stack(cp_params, cp_spec) -> torch.Tensor:
    """(S, C, F) bf16: each scale's basis, the diagonal blocks of the
    block-diagonal projection the kernels read."""
    with torch.no_grad():
        return torch.stack([cp_params[f"basis_{s}"] for s in range(len(cp_spec.resolutions))]
                           ).to(torch.bfloat16).contiguous()


def blockdiag_bt(basis) -> torch.Tensor:
    """(E, S*C) bf16 block-diagonal basis from the (S, C, F) stack: scale s's
    B^T in rows s*F.. and columns s*C.. (``_blockdiag_bt``)."""
    s_count, c, f = basis.shape
    bt = torch.zeros((s_count * f, s_count * c), dtype=torch.bfloat16, device=basis.device)
    for s in range(s_count):
        bt[s * f:(s + 1) * f, s * c:(s + 1) * c] = basis[s].T
    return bt


def coarse_line_grads(dfine, cp_spec):
    """The gradient of every ``line_{s}_{ax}`` (R_s, C) from the gradient of
    the (3, R_max, S*C) fine table: ``U^T d fine`` for an upsampled scale."""
    c = cp_spec.n_components
    rmax = max(cp_spec.resolutions)
    grads = {}
    for s, r in enumerate(cp_spec.resolutions):
        for ax in range(3):
            block = dfine[ax, :, s * c:(s + 1) * c]  # (R_max, C)
            if r != rmax:
                block = (_upsample(r, rmax, block.device).T @ block.double()).float()
            grads[f"line_{s}_{ax}"] = block
    return grads


def diagonal_blocks(dbt, s_count):
    """The (S, C, F) diagonal blocks of an (S*C, E) basis gradient."""
    c, f = dbt.shape[0] // s_count, dbt.shape[1] // s_count
    return torch.stack([dbt[s * c:(s + 1) * c, s * f:(s + 1) * f] for s in range(s_count)])


def _leaf_keys(cp_spec):
    s_count = len(cp_spec.resolutions)
    return ([f"line_{s}_{ax}" for s in range(s_count) for ax in range(3)]
            + [f"basis_{s}" for s in range(s_count)])


def cp_leaves(cp_params, cp_spec):
    """The CP parameter tensors in a fixed order: line_{s}_{ax} for every
    scale and axis, then basis_{s}."""
    return [cp_params[k] for k in _leaf_keys(cp_spec)]


def cp_from_leaves(leaves, cp_spec):
    """The CP parameter dict from the first ``cp_leaves`` entries."""
    return dict(zip(_leaf_keys(cp_spec), leaves))


# ---------------------------------------------------------------------------
# cp_jac_basis_stacked (K11 forward, K12 backward)
# ---------------------------------------------------------------------------


def cp_jac_basis_stacked(cp_params, u3, cp_spec):
    """``(enc (E, N), jac (3, E, N))`` over all scales from one op: enc =
    Bt (v_x v_y v_z) with the block-diagonal basis Bt, jac = d enc / d u3.
    Needs ``stackable(cp_spec)`` and ``n_features > 0``.

    With grad mode on and an input that requires grad, the forward also
    writes the residuals (K11 training mode) and the backward runs K12 (or
    the plain versions, on CPU tensors); otherwise (a rendered view, under
    ``no_grad``) K11 writes no residuals."""
    leaves = cp_leaves(cp_params, cp_spec)
    if torch.is_grad_enabled() and any(t.requires_grad for t in [u3, *leaves]):
        return _CPJacStacked.apply(u3, cp_spec, *leaves)
    lines, basis = stack_lines_fine(cp_params, cp_spec), basis_stack(cp_params, cp_spec)
    enc, jac, _, _ = _stacked_forward(lines, basis, u3, max(cp_spec.resolutions), train=False)
    return enc, jac


cp_jac_basis_stacked.launches = 0


def _stacked_forward(lines, basis, u3, rmax, train):
    if u3.device.type == "cuda":
        return cp_jac_basis_stacked_launch(lines, basis, u3, rmax, train=train)
    if u3.device.type == "cpu":
        if train:
            return cp_jac_basis_stacked_plain(lines, basis, u3, rmax, save_residuals=True)
        return (*cp_jac_basis_stacked_plain(lines, basis, u3, rmax), None, None)
    raise ValueError(f"cp_jac_basis_stacked: unsupported device {u3.device}")


class _CPJacStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u3, cp_spec, *leaves):
        cp_params = cp_from_leaves(leaves, cp_spec)
        lines, basis = stack_lines_fine(cp_params, cp_spec), basis_stack(cp_params, cp_spec)
        enc, jac, vsave, gdsave = _stacked_forward(lines, basis, u3, max(cp_spec.resolutions),
                                                   train=True)
        ctx.save_for_backward(u3, vsave, gdsave, basis)
        ctx.cp_spec = cp_spec
        return enc, jac

    @staticmethod
    @once_differentiable
    def backward(ctx, denc, djac):
        u3, vsave, gdsave, basis = ctx.saved_tensors
        spec = ctx.cp_spec
        dfine, du, dbasis = cp_jac_basis_stacked_backward(
            u3, vsave, gdsave, denc.contiguous(), djac.contiguous(), basis,
            max(spec.resolutions))
        lines = coarse_line_grads(dfine, spec)
        s_count = len(spec.resolutions)
        grads = [lines[f"line_{s}_{ax}"] for s in range(s_count) for ax in range(3)]
        grads += list(dbasis)
        return (du if ctx.needs_input_grad[0] else None), None, *grads


def cp_jac_basis_stacked_backward(u3, vsave, gdsave, denc, djac, basis, rmax):
    """The op's backward (K12): ``(d fine (3, R_max, S*C), du (3, N), dbasis
    (S, C, F))``, all f32, from the bf16 residuals and the (S, C, F) basis."""
    if u3.device.type == "cuda":
        return cp_jac_basis_stacked_backward_launch(u3, vsave, gdsave, denc, djac, basis, rmax)
    if u3.device.type == "cpu":
        return cp_jac_basis_stacked_backward_plain(u3, vsave, gdsave, denc, djac, basis, rmax)
    raise ValueError(f"cp_jac_basis_stacked_backward: unsupported device {u3.device}")


cp_jac_basis_stacked_backward.launches = 0


def cp_jac_basis_stacked_plain(lines, basis, u3, rmax, save_residuals=False):
    """Plain PyTorch version of K11 (``_jacs_fwd_kernel``) on the (3, R_max,
    S*C) fine table and the (S, C, F) basis: K9's plain version on the fine
    table with the full-width (S*C, E) block-diagonal basis, as the TPU
    multiplies. Returns ``(enc (E, N), jac (3, E, N))`` and, with
    ``save_residuals``, the (3, S*C, N) bf16 ``vsave`` and ``gdsave``."""
    return cp_product_jac_basis_plain(lines, blockdiag_bt(basis).T, u3, rmax,
                                      save_residuals=save_residuals)


def cp_jac_basis_stacked_backward_plain(u3, vsave, gdsave, denc, djac, basis, rmax):
    """Plain PyTorch version of K12 (``_jacs_bwd_kernel``): K10's plain
    version with the block-diagonal basis, then the diagonal (C, F) blocks of
    its (S*C, E) basis gradient. Returns ``(d fine, du, dbasis (S, C, F))``."""
    dfine, du, dbt = cp_product_jac_basis_backward_plain(
        u3, vsave, gdsave, denc, djac, blockdiag_bt(basis).T, rmax)
    return dfine, du, diagonal_blocks(dbt, basis.shape[0])


def cp_jac_basis_stacked_launch(lines, basis, u3, rmax, train=False):
    """Launch K11 (``cp_jac_stacked_fwd`` of ``csrc/cp_jac_basis_fwd.cu``) for
    CUDA u3. Returns ``(enc, jac, vsave, gdsave)``; the residuals only with
    ``train`` (else None). The launch plan goes to ``cuda_build.PLANS``; with
    no samples nothing is launched."""
    _check_coords("cp_jac_basis_stacked", u3)
    s_count, c, f = basis.shape
    n = u3.shape[1]
    u3 = u3.contiguous()
    cuda_build.check_operands("cp_jac_basis_stacked", (lines, basis),
                              [(3, rmax, s_count * c), (s_count, c, f)], u3.device)
    dev = u3.device
    enc = torch.empty((s_count * f, n), dtype=torch.float32, device=dev)
    jac = torch.empty((3, s_count * f, n), dtype=torch.float32, device=dev)
    vsave = gdsave = None
    if train:
        vsave = torch.empty((3, s_count * c, n), dtype=torch.bfloat16, device=dev)
        gdsave = torch.empty((3, s_count * c, n), dtype=torch.bfloat16, device=dev)
    fn = cuda_build.entry("cp_jac_basis_fwd", "cp_jac_stacked_fwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(u3.data_ptr(), n, lines.data_ptr(), rmax, c, f, s_count, basis.data_ptr(),
                enc.data_ptr(), jac.data_ptr(), vsave.data_ptr() if train else None,
                gdsave.data_ptr() if train else None, info, stream)
    cuda_build.check(rc, "cp_jac_basis_stacked", SUPPORTED)
    cuda_build.record_plan(("cp_jac_stacked_fwd", c, f, s_count, train, dev.index), info)
    cp_jac_basis_stacked.launches += int(n > 0)  # N = 0 launches nothing
    return enc, jac, vsave, gdsave


def cp_jac_basis_stacked_backward_launch(u3, vsave, gdsave, denc, djac, basis, rmax):
    """Launch K12 (``cp_jac_stacked_bwd`` of ``csrc/cp_jac_basis_bwd.cu``);
    see :func:`cp_jac_basis_stacked_backward`. d basis comes from per-block
    partial sums added in block order, the fine table from atomics. With no
    samples it returns zeros and launches nothing."""
    _check_coords("cp_jac_basis_stacked_backward", u3)
    s_count, c, f = basis.shape
    n = u3.shape[1]
    u3 = u3.contiguous()
    if denc.dtype != torch.float32 or djac.dtype != torch.float32:
        raise ValueError("cp_jac_basis_stacked_backward: cotangents must be float32")
    sc, e = s_count * c, s_count * f
    cuda_build.check_operands("cp_jac_basis_stacked_backward",
                              (vsave, gdsave, denc, djac, basis),
                              [(3, sc, n), (3, sc, n), (e, n), (3, e, n), (s_count, c, f)],
                              u3.device)
    dev = u3.device
    dfine = torch.zeros((3, rmax, sc), dtype=torch.float32, device=dev)
    du = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return dfine, du, torch.zeros((s_count, c, f), dtype=torch.float32, device=dev)
    fn = cuda_build.entry("cp_jac_basis_bwd", "cp_jac_stacked_bwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(part, blocks, out, info, n_):
            return fn(u3.data_ptr(), n_, rmax, c, f, s_count, vsave.data_ptr(),
                      gdsave.data_ptr(), denc.data_ptr(), djac.data_ptr(), basis.data_ptr(),
                      dfine.data_ptr(), du.data_ptr(), part, blocks, out, info, stream)

        out = cuda_build.launch_persistent(("cp_jac_stacked_bwd", c, f, s_count, dev.index),
                                           call, n, dev, "cp_jac_basis_stacked_backward",
                                           SUPPORTED)
    cp_jac_basis_stacked_backward.launches += 1
    return dfine, du, out.view(s_count, c, f)
