"""CP line product, the CP product with its analytic Jacobian, and the same
with the basis projection fused, forward and backward.

Port of ``instant_nsr_pl_tpu/ops/cp_pallas.py`` ``cp_product`` (K5 forward,
K6 backward), ``cp_product_jac`` (K7 forward, K8 backward) and
``cp_product_jac_basis`` (K9 forward, K10 backward) with their custom VJPs.
On CUDA tensors each op launches its hand-written kernel
(``csrc/cp_product_fwd.cu``, ``csrc/cp_product_jac_fwd.cu``,
``csrc/cp_jac_basis_fwd.cu``, and ``csrc/cp_jac_basis_bwd.cu`` for K10 and,
without the basis, K8 and K6); on CPU tensors it
runs the plain PyTorch versions below, at the TPU kernels' rounding points.
There is no fallback from one to the other.

Layouts follow the TPU kernels: coordinates ``u3`` (3, N) in [0, 1] (clipped),
outputs feature-major (``prod`` (C, N), ``enc`` (F, N), ``jac`` (3, C, N) or
(3, F, N)), residuals (3, C, N) bf16. The line tables enter as the JAX op's (R, C) f32
tables and are stacked into one (3, R, C) bf16 operand (rows contiguous for
the kernels' two-row reads); the basis enters as (C, F) and is used in bf16.

Precision contract (the TPU kernels'): bf16 tables and basis; each tent
weight computed as ``1 - |r - p|`` in f32 and rounded to bf16
(:func:`tent_coords`); each interpolated value ``w0 * L[i0] + w1 * L[i0+1]``
rounded once; the diff-hot derivative ``L[i0+1] - L[i0]`` exact; the
projections take bf16 operands with f32 sums. The backwards read the bf16
residuals, round the scatter operands ``d_v`` / ``d_gd`` to bf16, and take
``d u`` from the f32 ``d_v``.

``cp_product_jac`` and ``cp_product_jac_basis`` return the Jacobian as a
forward output, so the NeuS eikonal loss's second-order graph never
differentiates through them: their backwards are first-order only
(``once_differentiable``).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops.mlp import bf16_round

# The shapes the kernels instantiate: C of K5-K8 (csrc/cp_product_*.cu; K6 and
# K8 in csrc/cp_jac_basis_bwd.cu) and (C, F) of K9/K10 (csrc/cp_jac_basis_*.cu): the
# bench NeuS encodings of bench.py --encoding cp (64) and cp_big (128), and the
# small test models (16).
PRODUCT_COMPONENTS = (128, 64, 16)
JAC_BASIS_SHAPES = ((128, 16), (64, 16), (16, 8))
SUPPORTED_PRODUCT = f"C in {PRODUCT_COMPONENTS}, R >= 2"
SUPPORTED_JAC = f"(C, F) in {JAC_BASIS_SHAPES}, R >= 2"


# ---------------------------------------------------------------------------
# the per-axis operands (cp_pallas.py _axis_p, _tent, _diffhot, _inrange_half)
# ---------------------------------------------------------------------------


def inrange_half(u):
    """d clip(u, 0, 1)/du with JAX's tie convention: 0 outside [0, 1], 0.5 at
    exactly 0 or 1, 1 inside."""
    one = torch.ones_like(u)
    edge = torch.where((u == 0.0) | (u == 1.0), 0.5 * one, one)
    return torch.where((u < 0.0) | (u > 1.0), torch.zeros_like(u), edge)


def _fma_sub(r, cu, scale):
    """float32 ``r - cu * scale`` rounded once, as a fused multiply-add: the
    product is exact in float64 and so is the difference."""
    return (r.double() - cu.double() * scale).float()


def tent_coords(u, res):
    """The two non-zeros of the TPU kernel's tent column for coordinates u
    (N,): row ``i0 = min(floor(p), R - 2)`` of ``p = clip(u, 0, 1) * (R - 1)``,
    the bf16 weights ``max(0, 1 - |r - p|)`` of rows i0 and i0 + 1, and ``s =
    (R - 1) * d clip(u)/du``, the scale of the diff-hot derivative.

    ``r - p`` is evaluated as the JAX package's compiled kernel evaluates it,
    ``r - clip(u) * (R - 1)`` contracted into one fused multiply-add (the
    kernels call ``fmaf``): with ``p`` rounded first, a weight near a bf16
    rounding midpoint can land one bf16 ulp away."""
    u = u.float()
    cu = torch.clamp(u, 0.0, 1.0)
    i0 = torch.clamp(torch.floor(cu * (res - 1)), max=float(res - 2))
    w0 = bf16_round(torch.clamp(1.0 - _fma_sub(i0, cu, res - 1).abs(), min=0.0))
    w1 = bf16_round(torch.clamp(1.0 - _fma_sub(i0 + 1.0, cu, res - 1).abs(), min=0.0))
    return i0.long(), w0, w1, (res - 1) * inrange_half(u)


def line_stack(lx, ly, lz):
    """The (3, R, C) bf16 line stack the kernels and plain versions read."""
    with torch.no_grad():
        return torch.stack([lx, ly, lz]).to(torch.bfloat16).contiguous()


def _rows(table, i0):
    """Rows i0 and i0 + 1 of an (R, C) f32 table: (N, C) each."""
    return torch.index_select(table, 0, i0), torch.index_select(table, 0, i0 + 1)


# ---------------------------------------------------------------------------
# cp_product (K5 forward, K6 backward)
# ---------------------------------------------------------------------------


def cp_product(lx, ly, lz, u3, res):
    """prod (C, N) = v_x * v_y * v_z: the linear interpolations of the (R, C)
    line tables ``lx, ly, lz`` at the (3, N) coordinates ``u3``.

    With grad mode on and an input that requires grad, the op records its
    backward: the forward then also writes the residual (K5 training mode)
    and the backward runs K6 (or the plain versions, on CPU tensors)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (lx, ly, lz, u3)):
        return _CPProduct.apply(lx, ly, lz, u3, res)
    return _product_forward(line_stack(lx, ly, lz), u3, res, train=False)[0]


cp_product.launches = 0


def _product_forward(lines, u3, res, train):
    if u3.device.type == "cuda":
        return cp_product_launch(lines, u3, res, train=train)
    if u3.device.type == "cpu":
        if train:
            return cp_product_plain(lines, u3, res, save_residuals=True)
        return cp_product_plain(lines, u3, res), None
    raise ValueError(f"cp_product: unsupported device {u3.device}")


class _CPProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lx, ly, lz, u3, res):
        lines = line_stack(lx, ly, lz)
        prod, vsave = _product_forward(lines, u3, res, train=True)
        ctx.save_for_backward(lines, u3, vsave)
        ctx.res = res
        return prod

    @staticmethod
    @once_differentiable
    def backward(ctx, dprod):
        lines, u3, vsave = ctx.saved_tensors
        dl, du = cp_product_backward(lines, u3, vsave, dprod.contiguous(), ctx.res)
        return dl[0], dl[1], dl[2], (du if ctx.needs_input_grad[3] else None), None


def cp_product_backward(lines, u3, vsave, dprod, res):
    """The op's backward (K6): ``(dlines (3, R, C) f32, du (3, N) f32)``."""
    if u3.device.type == "cuda":
        return cp_product_backward_launch(lines, u3, vsave, dprod, res)
    if u3.device.type == "cpu":
        return cp_product_backward_plain(lines, u3, vsave, dprod, res)
    raise ValueError(f"cp_product_backward: unsupported device {u3.device}")


cp_product_backward.launches = 0


def cp_product_plain(lines, u3, res, save_residuals=False):
    """Plain PyTorch version of K5 on the (3, R, C) bf16 line stack: prod
    (C, N) f32, and with ``save_residuals`` also vsave (3, C, N) bf16."""
    table = lines.float()
    vs = []
    for ax in range(3):
        i0, w0, w1, _ = tent_coords(u3[ax], res)
        r0, r1 = _rows(table[ax], i0)
        vs.append(r0 * w0[:, None] + r1 * w1[:, None])  # (N, C), exact products
    prod = ((vs[0] * vs[1]) * vs[2]).T.contiguous()
    if not save_residuals:
        return prod
    vsave = torch.stack(vs).transpose(1, 2).to(torch.bfloat16).contiguous()
    return prod, vsave


def cp_product_backward_plain(lines, u3, vsave, dprod, res):
    """Plain PyTorch version of K6 (``_bwd_kernel``): from the bf16 residual,
    ``d_v = dp * others`` in f32, ``gd`` from the bf16 table, ``du = sum_C
    d_v * gd * s`` and the scatter of ``bf16(d_v) * tent`` into rows i0 and
    i0 + 1. Returns ``(dlines (3, R, C), du (3, N))``."""
    table = lines.float()
    v = vsave.float()
    others = (v[1] * v[2], v[0] * v[2], v[0] * v[1])
    n = u3.shape[1]
    dlines = torch.zeros(tuple(lines.shape), dtype=torch.float32, device=u3.device)
    du = torch.empty((3, n), dtype=torch.float32, device=u3.device)
    for ax in range(3):
        i0, w0, w1, s = tent_coords(u3[ax], res)
        d_v = dprod * others[ax]  # (C, N) f32
        r0, r1 = _rows(table[ax], i0)
        gd = (r1 - r0).T
        du[ax] = (d_v * gd).sum(0) * s
        dvr = bf16_round(d_v).T  # (N, C)
        dlines[ax].index_add_(0, i0, dvr * w0[:, None])
        dlines[ax].index_add_(0, i0 + 1, dvr * w1[:, None])
    return dlines, du


def _check_coords(name, u3):
    if u3.dtype != torch.float32 or u3.ndim != 2 or u3.shape[0] != 3:
        raise ValueError(f"{name}: u3 must be (3, N) float32, got {tuple(u3.shape)} {u3.dtype}")


def cp_product_launch(lines, u3, res, train=False):
    """Launch ``csrc/cp_product_fwd.cu`` (K5) on the (3, R, C) bf16 stack for
    CUDA u3. Returns ``(prod, vsave)``; vsave only with ``train`` (else None).
    The launch plan (grid, blocks per SM, shared memory) goes to
    ``cuda_build.PLANS``; with no samples nothing is launched."""
    _check_coords("cp_product", u3)
    c = lines.shape[2]
    n = u3.shape[1]
    u3 = u3.contiguous()
    cuda_build.check_operands("cp_product", (lines,), [(3, res, c)], u3.device)
    prod = torch.empty((c, n), dtype=torch.float32, device=u3.device)
    vsave = (torch.empty((3, c, n), dtype=torch.bfloat16, device=u3.device)
             if train else None)
    fn = cuda_build.entry("cp_product_fwd", "cp_product_fwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(u3.device):
        stream = torch.cuda.current_stream(u3.device).cuda_stream
        rc = fn(u3.data_ptr(), n, lines.data_ptr(), res, c, prod.data_ptr(),
                vsave.data_ptr() if train else None, info, stream)
    cuda_build.check(rc, "cp_product", SUPPORTED_PRODUCT)
    cuda_build.record_plan(("cp_product_fwd", c, train, u3.device.index), info)
    cp_product.launches += int(n > 0)  # N = 0 launches nothing
    return prod, vsave


def cp_product_backward_launch(lines, u3, vsave, dprod, res):
    """Launch K6 (the line-table instantiation of ``csrc/cp_jac_basis_bwd.cu``);
    see :func:`cp_product_backward`. The line tables come from atomics. With
    no samples it returns zeros and launches nothing."""
    _check_coords("cp_product_backward", u3)
    c = lines.shape[2]
    n = u3.shape[1]
    u3 = u3.contiguous()
    if dprod.dtype != torch.float32:
        raise ValueError(f"cp_product_backward: dprod must be float32, got {dprod.dtype}")
    cuda_build.check_operands("cp_product_backward", (lines, vsave, dprod),
                              [(3, res, c), (3, c, n), (c, n)], u3.device)
    dev = u3.device
    dlines = torch.zeros((3, res, c), dtype=torch.float32, device=dev)
    du = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return dlines, du
    fn = cuda_build.entry("cp_jac_basis_bwd", "cp_product_bwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(u3.data_ptr(), n, lines.data_ptr(), res, c, vsave.data_ptr(),
                dprod.data_ptr(), dlines.data_ptr(), du.data_ptr(), info, stream)
    cuda_build.check(rc, "cp_product_backward", SUPPORTED_PRODUCT)
    cuda_build.record_plan(("cp_product_bwd", c, dev.index), info)
    cp_product_backward.launches += 1
    return dlines, du


# ---------------------------------------------------------------------------
# cp_product_jac (K7 forward, K8 backward): the raw products, no basis
# ---------------------------------------------------------------------------


def cp_product_jac(lx, ly, lz, u3, res):
    """``(prod (C, N), jac (3, C, N))``: prod = v_x v_y v_z of the (R, C)
    line tables at the (3, N) coordinates ``u3``, and jac = d prod / d u3,
    from one op (the CP encoding without a basis, ``n_features: 0``).

    With grad mode on and an input that requires grad, the forward also
    writes the residuals (K7 training mode) and the backward runs K8 (or the
    plain versions, on CPU tensors); otherwise (a rendered view, export
    vertex colours, under ``no_grad``) K7 writes no residuals."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (lx, ly, lz, u3)):
        return _CPProductJac.apply(lx, ly, lz, u3, res)
    prod, jac, _, _ = _product_jac_forward(line_stack(lx, ly, lz), u3, res, train=False)
    return prod, jac


cp_product_jac.launches = 0


def _product_jac_forward(lines, u3, res, train):
    if u3.device.type == "cuda":
        return cp_product_jac_launch(lines, u3, res, train=train)
    if u3.device.type == "cpu":
        if train:
            return cp_product_jac_plain(lines, u3, res, save_residuals=True)
        return (*cp_product_jac_plain(lines, u3, res), None, None)
    raise ValueError(f"cp_product_jac: unsupported device {u3.device}")


class _CPProductJac(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lx, ly, lz, u3, res):
        prod, jac, vsave, gdsave = _product_jac_forward(line_stack(lx, ly, lz), u3, res,
                                                        train=True)
        ctx.save_for_backward(u3, vsave, gdsave)
        ctx.res = res
        return prod, jac

    @staticmethod
    @once_differentiable
    def backward(ctx, dprod, djac):
        u3, vsave, gdsave = ctx.saved_tensors
        dl, du = cp_product_jac_backward(u3, vsave, gdsave, dprod.contiguous(),
                                         djac.contiguous(), ctx.res)
        return dl[0], dl[1], dl[2], (du if ctx.needs_input_grad[3] else None), None


def cp_product_jac_backward(u3, vsave, gdsave, dprod, djac, res):
    """The op's backward (K8): ``(dlines (3, R, C), du (3, N))``, both f32,
    from the bf16 residuals."""
    if u3.device.type == "cuda":
        return cp_product_jac_backward_launch(u3, vsave, gdsave, dprod, djac, res)
    if u3.device.type == "cpu":
        return cp_product_jac_backward_plain(u3, vsave, gdsave, dprod, djac, res)
    raise ValueError(f"cp_product_jac_backward: unsupported device {u3.device}")


cp_product_jac_backward.launches = 0


def cp_product_jac_plain(lines, u3, res, save_residuals=False):
    """Plain PyTorch version of K7 (``_jac_fwd_kernel``) on the (3, R, C)
    bf16 stack: ``(prod (C, N), jac (3, C, N))`` in f32 and, with
    ``save_residuals``, the (3, C, N) bf16 ``vsave``, ``gdsave``."""
    table = lines.float()
    vs, gds, gs = [], [], []
    for ax in range(3):
        i0, w0, w1, s = tent_coords(u3[ax], res)
        r0, r1 = _rows(table[ax], i0)
        vs.append(r0 * w0[:, None] + r1 * w1[:, None])  # (N, C)
        gds.append(r1 - r0)
        gs.append(gds[-1] * s[:, None])
    prod = ((vs[0] * vs[1]) * vs[2]).T.contiguous()
    jac = torch.stack([
        gs[0] * (vs[1] * vs[2]),
        gs[1] * (vs[0] * vs[2]),
        gs[2] * (vs[0] * vs[1]),
    ]).transpose(1, 2).contiguous()
    if not save_residuals:
        return prod, jac
    vsave = torch.stack(vs).transpose(1, 2).to(torch.bfloat16).contiguous()
    gdsave = torch.stack(gds).transpose(1, 2).to(torch.bfloat16).contiguous()
    return prod, jac, vsave, gdsave


def cp_product_jac_backward_plain(u3, vsave, gdsave, dprod, djac, res):
    """Plain PyTorch version of K8 (``_jac_bwd_kernel``) at its rounding
    points: the f32 cotangents as given, ``d_v`` and ``d_gd`` rounded to bf16
    for the row scatter, ``du`` from the f32 ``d_v``. Returns ``(dlines (3,
    R, C), du (3, N))``."""
    c = vsave.shape[1]
    n = u3.shape[1]
    v = vsave.float()
    gd = gdsave.float()
    coords = [tent_coords(u3[ax], res) for ax in range(3)]
    ss = [co[3] for co in coords]
    others = (v[1] * v[2], v[0] * v[2], v[0] * v[1])
    gs = [(djac[ax] * gd[ax]) * ss[ax] for ax in range(3)]
    dlines = torch.zeros((3, res, c), dtype=torch.float32, device=u3.device)
    du = torch.empty((3, n), dtype=torch.float32, device=u3.device)
    for ax in range(3):
        b1, b2 = [b for b in range(3) if b != ax]
        d_v = dprod * others[ax] + gs[b1] * v[b2] + gs[b2] * v[b1]
        d_gd = (djac[ax] * ss[ax]) * others[ax]
        du[ax] = (d_v * gd[ax]).sum(0) * ss[ax]
        i0, w0, w1, _ = coords[ax]
        dvr, dgr = bf16_round(d_v).T, bf16_round(d_gd).T  # (N, C)
        dlines[ax].index_add_(0, i0, dvr * w0[:, None] - dgr)
        dlines[ax].index_add_(0, i0 + 1, dvr * w1[:, None] + dgr)
    return dlines, du


def cp_product_jac_launch(lines, u3, res, train=False):
    """Launch ``csrc/cp_product_jac_fwd.cu`` (K7) on the (3, R, C) bf16 stack
    for CUDA u3. Returns ``(prod, jac, vsave, gdsave)``; the residuals only
    with ``train`` (else None)."""
    _check_coords("cp_product_jac", u3)
    c = lines.shape[2]
    n = u3.shape[1]
    u3 = u3.contiguous()
    cuda_build.check_operands("cp_product_jac", (lines,), [(3, res, c)], u3.device)
    dev = u3.device
    prod = torch.empty((c, n), dtype=torch.float32, device=dev)
    jac = torch.empty((3, c, n), dtype=torch.float32, device=dev)
    vsave = gdsave = None
    if train:
        vsave = torch.empty((3, c, n), dtype=torch.bfloat16, device=dev)
        gdsave = torch.empty((3, c, n), dtype=torch.bfloat16, device=dev)
    fn = cuda_build.library("cp_product_jac_fwd").cp_product_jac_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(u3.data_ptr(), n, lines.data_ptr(), res, c, prod.data_ptr(), jac.data_ptr(),
                vsave.data_ptr() if train else None, gdsave.data_ptr() if train else None,
                stream)
    cuda_build.check(rc, "cp_product_jac", SUPPORTED_PRODUCT)
    cp_product_jac.launches += 1
    return prod, jac, vsave, gdsave


def cp_product_jac_backward_launch(u3, vsave, gdsave, dprod, djac, res):
    """Launch K8 (the raw-product instantiation of ``csrc/cp_jac_basis_bwd.cu``);
    see :func:`cp_product_jac_backward`. The line tables come from atomics.
    With no samples it returns zeros and launches nothing."""
    _check_coords("cp_product_jac_backward", u3)
    c = vsave.shape[1]
    n = u3.shape[1]
    u3 = u3.contiguous()
    if dprod.dtype != torch.float32 or djac.dtype != torch.float32:
        raise ValueError("cp_product_jac_backward: cotangents must be float32")
    cuda_build.check_operands("cp_product_jac_backward", (vsave, gdsave, dprod, djac),
                              [(3, c, n), (3, c, n), (c, n), (3, c, n)], u3.device)
    dev = u3.device
    dlines = torch.zeros((3, res, c), dtype=torch.float32, device=dev)
    du = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return dlines, du
    fn = cuda_build.entry("cp_jac_basis_bwd", "cp_product_jac_bwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(u3.data_ptr(), n, res, c, vsave.data_ptr(), gdsave.data_ptr(),
                dprod.data_ptr(), djac.data_ptr(), dlines.data_ptr(), du.data_ptr(), info, stream)
    cuda_build.check(rc, "cp_product_jac_backward", SUPPORTED_PRODUCT)
    cuda_build.record_plan(("cp_product_jac_bwd", c, dev.index), info)
    cp_product_jac_backward.launches += 1
    return dlines, du


# ---------------------------------------------------------------------------
# cp_product_jac_basis (K9 forward, K10 backward)
# ---------------------------------------------------------------------------


def cp_product_jac_basis(lx, ly, lz, basis, u3, res):
    """``(enc (F, N), jac (3, F, N))``: enc = B^T (v_x v_y v_z) with the (C, F)
    ``basis`` B, and jac = d enc / d u3, from one op.

    With grad mode on and an input that requires grad, the forward also
    writes the residuals (K9 training mode) and the backward runs K10 (or the
    plain versions, on CPU tensors); otherwise (a rendered view, under
    ``no_grad``) K9 writes no residuals."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (lx, ly, lz, basis, u3)):
        return _CPJacBasis.apply(lx, ly, lz, basis, u3, res)
    with torch.no_grad():
        bas = basis.to(torch.bfloat16).contiguous()
    enc, jac, _, _ = _jac_forward(line_stack(lx, ly, lz), bas, u3, res, train=False)
    return enc, jac


cp_product_jac_basis.launches = 0


def _jac_forward(lines, basis, u3, res, train):
    if u3.device.type == "cuda":
        return cp_product_jac_basis_launch(lines, basis, u3, res, train=train)
    if u3.device.type == "cpu":
        if train:
            return cp_product_jac_basis_plain(lines, basis, u3, res, save_residuals=True)
        return (*cp_product_jac_basis_plain(lines, basis, u3, res), None, None)
    raise ValueError(f"cp_product_jac_basis: unsupported device {u3.device}")


class _CPJacBasis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lx, ly, lz, basis, u3, res):
        lines = line_stack(lx, ly, lz)
        bas = basis.to(torch.bfloat16).contiguous()
        enc, jac, vsave, gdsave = _jac_forward(lines, bas, u3, res, train=True)
        ctx.save_for_backward(u3, vsave, gdsave, bas)
        ctx.res = res
        return enc, jac

    @staticmethod
    @once_differentiable
    def backward(ctx, denc, djac):
        u3, vsave, gdsave, bas = ctx.saved_tensors
        dl, du, dbasis = cp_product_jac_basis_backward(
            u3, vsave, gdsave, denc.contiguous(), djac.contiguous(), bas, ctx.res)
        du = du if ctx.needs_input_grad[4] else None
        return dl[0], dl[1], dl[2], dbasis, du, None


def cp_product_jac_basis_backward(u3, vsave, gdsave, denc, djac, basis, res):
    """The op's backward (K10): ``(dlines (3, R, C), du (3, N), dbasis (C,
    F))``, all f32, from the bf16 residuals and the (C, F) bf16 basis."""
    if u3.device.type == "cuda":
        return cp_product_jac_basis_backward_launch(u3, vsave, gdsave, denc, djac, basis, res)
    if u3.device.type == "cpu":
        return cp_product_jac_basis_backward_plain(u3, vsave, gdsave, denc, djac, basis, res)
    raise ValueError(f"cp_product_jac_basis_backward: unsupported device {u3.device}")


cp_product_jac_basis_backward.launches = 0


def cp_product_jac_basis_plain(lines, basis, u3, res, save_residuals=False):
    """Plain PyTorch version of K9 (``_jacb_fwd_kernel``) on the (3, R, C)
    bf16 stack and the (C, F) bf16 basis: ``(enc (F, N), jac (3, F, N))``
    and, with ``save_residuals``, the (3, C, N) bf16 ``vsave``, ``gdsave``."""
    table = lines.float()
    bas = basis.float()
    vs, gds, gs = [], [], []
    for ax in range(3):
        i0, w0, w1, s = tent_coords(u3[ax], res)
        r0, r1 = _rows(table[ax], i0)
        vs.append(r0 * w0[:, None] + r1 * w1[:, None])  # (N, C)
        gds.append(r1 - r0)
        gs.append(gds[-1] * s[:, None])
    enc = (bf16_round((vs[0] * vs[1]) * vs[2]) @ bas).T
    jac = torch.stack([
        bf16_round(gs[0] * (vs[1] * vs[2])) @ bas,
        bf16_round(gs[1] * (vs[0] * vs[2])) @ bas,
        bf16_round(gs[2] * (vs[0] * vs[1])) @ bas,
    ]).transpose(1, 2)
    enc, jac = enc.contiguous(), jac.contiguous()
    if not save_residuals:
        return enc, jac
    vsave = torch.stack(vs).transpose(1, 2).to(torch.bfloat16).contiguous()
    gdsave = torch.stack(gds).transpose(1, 2).to(torch.bfloat16).contiguous()
    return enc, jac, vsave, gdsave


def cp_product_jac_basis_backward_plain(u3, vsave, gdsave, denc, djac, basis, res):
    """Plain PyTorch version of K10 (``_jacb_bwd_kernel``) at its rounding
    points: ``prod`` and ``jpre`` recomputed from the bf16 residuals, the
    cotangents rounded to bf16 before the projections, ``d_v`` and ``d_gd``
    rounded to bf16 for the row scatter, ``du`` from the f32 ``d_v``.
    Returns ``(dlines (3, R, C), du (3, N), dbasis (C, F))``."""
    c = vsave.shape[1]
    n = u3.shape[1]
    v = vsave.float()
    gd = gdsave.float()
    bas = basis.float()  # (C, F)
    coords = [tent_coords(u3[ax], res) for ax in range(3)]
    ss = [co[3] for co in coords]
    others = (v[1] * v[2], v[0] * v[2], v[0] * v[1])
    prod = v[0] * others[0]
    jpre = [gd[ax] * ss[ax] * others[ax] for ax in range(3)]  # (C, N)
    de = bf16_round(denc)  # (F, N)
    dj = bf16_round(djac)  # (3, F, N)
    dbasis = bf16_round(prod) @ de.T
    for ax in range(3):
        dbasis = dbasis + bf16_round(jpre[ax]) @ dj[ax].T
    dp = bas @ de  # (C, N)
    djs = [bas @ dj[ax] for ax in range(3)]
    gs = [djs[ax] * gd[ax] * ss[ax] for ax in range(3)]
    dlines = torch.zeros((3, res, c), dtype=torch.float32, device=u3.device)
    du = torch.empty((3, n), dtype=torch.float32, device=u3.device)
    for ax in range(3):
        b1, b2 = [b for b in range(3) if b != ax]
        d_v = dp * others[ax] + gs[b1] * v[b2] + gs[b2] * v[b1]
        d_gd = djs[ax] * ss[ax] * others[ax]
        du[ax] = (d_v * gd[ax]).sum(0) * ss[ax]
        i0, w0, w1, _ = coords[ax]
        dvr, dgr = bf16_round(d_v).T, bf16_round(d_gd).T  # (N, C)
        dlines[ax].index_add_(0, i0, dvr * w0[:, None] - dgr)
        dlines[ax].index_add_(0, i0 + 1, dvr * w1[:, None] + dgr)
    return dlines, du, dbasis


def cp_product_jac_basis_launch(lines, basis, u3, res, train=False):
    """Launch ``csrc/cp_jac_basis_fwd.cu`` (K9) for CUDA u3. Returns ``(enc,
    jac, vsave, gdsave)``; the residuals only with ``train`` (else None). The
    launch plan goes to ``cuda_build.PLANS``; with no samples nothing is
    launched."""
    _check_coords("cp_product_jac_basis", u3)
    c, f = basis.shape
    n = u3.shape[1]
    u3 = u3.contiguous()
    cuda_build.check_operands("cp_product_jac_basis", (lines, basis),
                              [(3, res, c), (c, f)], u3.device)
    dev = u3.device
    enc = torch.empty((f, n), dtype=torch.float32, device=dev)
    jac = torch.empty((3, f, n), dtype=torch.float32, device=dev)
    vsave = gdsave = None
    if train:
        vsave = torch.empty((3, c, n), dtype=torch.bfloat16, device=dev)
        gdsave = torch.empty((3, c, n), dtype=torch.bfloat16, device=dev)
    fn = cuda_build.entry("cp_jac_basis_fwd", "cp_jac_basis_fwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(u3.data_ptr(), n, lines.data_ptr(), res, c, f, basis.data_ptr(),
                enc.data_ptr(), jac.data_ptr(), vsave.data_ptr() if train else None,
                gdsave.data_ptr() if train else None, info, stream)
    cuda_build.check(rc, "cp_product_jac_basis", SUPPORTED_JAC)
    cuda_build.record_plan(("cp_jac_basis_fwd", c, f, train, dev.index), info)
    cp_product_jac_basis.launches += int(n > 0)  # N = 0 launches nothing
    return enc, jac, vsave, gdsave


def cp_product_jac_basis_backward_launch(u3, vsave, gdsave, denc, djac, basis, res):
    """Launch ``csrc/cp_jac_basis_bwd.cu`` (K10); see
    :func:`cp_product_jac_basis_backward`. d basis comes from per-block
    partial sums added in block order by a second kernel, the line tables
    from atomics. With no samples it returns zeros and launches nothing."""
    _check_coords("cp_product_jac_basis_backward", u3)
    c, f = basis.shape
    n = u3.shape[1]
    u3 = u3.contiguous()
    if denc.dtype != torch.float32 or djac.dtype != torch.float32:
        raise ValueError("cp_product_jac_basis_backward: cotangents must be float32")
    cuda_build.check_operands("cp_product_jac_basis_backward",
                              (vsave, gdsave, denc, djac, basis),
                              [(3, c, n), (3, c, n), (f, n), (3, f, n), (c, f)], u3.device)
    dev = u3.device
    dlines = torch.zeros((3, res, c), dtype=torch.float32, device=dev)
    du = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return dlines, du, torch.zeros((c, f), dtype=torch.float32, device=dev)
    fn = cuda_build.entry("cp_jac_basis_bwd", "cp_jac_basis_bwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(part, blocks, out, info, n_):
            return fn(u3.data_ptr(), n_, res, c, f, vsave.data_ptr(), gdsave.data_ptr(),
                      denc.data_ptr(), djac.data_ptr(), basis.data_ptr(), dlines.data_ptr(),
                      du.data_ptr(), part, blocks, out, info, stream)

        out = cuda_build.launch_persistent(("cp_jac_basis_bwd", c, f, dev.index), call, n, dev,
                                           "cp_product_jac_basis_backward", SUPPORTED_JAC)
    cp_product_jac_basis_backward.launches += 1
    return dlines, du, out.view(c, f)
