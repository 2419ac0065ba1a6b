"""Vector-Matrix factorized encoding (TensoRF-style), forward and gradients.

Port of ``instant_nsr_pl_tpu/ops/vm.py``: :class:`VMSpec` (:41-69, field for
field), :func:`vm_init` (:72-91), the tap helpers (:93-133), :func:`vm_encode`
(:136, the plain composed version, differentiable at any order) and
:func:`vm_encode_fast` (:166-240, first order). Per sample and scale ``s``
the encoding reads

- three factor planes ``plane_{s}_{k}``, (R_s^2, C) float32, bilinear (4 taps),
- three factor lines ``line_{s}_{k}``, (R_l, C) float32, linear (2 taps),

and outputs ``concat_{s,k}(P_k(a, b) * L_k(c))``, (..., S * 3 * C), with plane
``k`` over axes (a, b) and its line along c: (0, 1 | 2), (0, 2 | 1), (1, 2 | 0).
A tap's cell is ``floor(clip(u, 0, 1) * (R - 1))`` clipped to ``R - 2``, so
``u = 1`` takes the last cell with weight 1. Rows are (rows, C) in both
packages: JAX weights carry across as copies (``utils/transplant.py``).

``vm_encode_fast`` launches ``csrc/vm_fwd.cu`` (VM1) in its forward and
``csrc/vm_bwd.cu`` (VM2) in its backward on CUDA tensors, and runs the plain
versions (:func:`vm_encode`, :func:`vm_backward_plain`) on CPU tensors; there
is no fallback from one to the other. The JAX fast path is XLA: it sums the
table gradients with two sorts (``ops/segment.py``), because the TPU
serialises scatters; VM2 merges equal rows of neighbouring (ray-ordered)
samples and adds float atomics of whole rows into the zeroed gradient, and
the plain backward one ``index_add_`` per table. ``x`` gets a gradient only when
it requires one; its mask drops samples at exactly 0 or 1 on an axis, as the
JAX backward does.

Rounding: the 4 plane taps and the 2 line taps are summed in tap order, each
product rounded before its sum (the plain version writes the sum out, the
kernels are built with ``--fmad=false``), so VM1 equals the plain forward to
the bit.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops.segment import segment_sum_dense_sorted

MAX_SCALES = 4  # the kernels' per-table parameter arrays hold 3 * MAX_SCALES
COMPONENTS = (4, 8, 16, 32)  # the kernels' instantiations of n_components


@dataclasses.dataclass(frozen=True)
class VMSpec:
    """Static description of a VM encoding."""

    n_components: int = 16
    plane_resolution: int = 512
    line_resolution: int = 2048
    n_scales: int = 1
    scale_factor: float = 2.0  # plane res of scale s = R / factor^s

    # plane k pairs axes (a, b); its line runs along the third axis c
    AXES = ((0, 1, 2), (0, 2, 1), (1, 2, 0))

    def plane_res(self, s: int) -> int:
        return max(8, int(round(self.plane_resolution / self.scale_factor**s)))

    @property
    def n_output_dims(self) -> int:
        return self.n_scales * 3 * self.n_components

    def keys(self) -> tuple[str, ...]:
        """The parameter names in the kernels' table order: per scale and
        plane, the plane then its line."""
        return tuple(name for s in range(self.n_scales) for k in range(3)
                     for name in (f"plane_{s}_{k}", f"line_{s}_{k}"))

    @classmethod
    def from_config(cls, config) -> "VMSpec":
        return cls(
            n_components=int(config.get("n_components", 16)),
            plane_resolution=int(config.get("plane_resolution", 512)),
            line_resolution=int(config.get("line_resolution", 2048)),
            n_scales=int(config.get("n_scales", 1)),
            scale_factor=float(config.get("scale_factor", 2.0)),
        )


def vm_init(generator: torch.Generator, spec: VMSpec, device=None):
    """TensoRF-style init: planes ``0.1 * N(0, 1)`` of shape (R_s^2, C), lines
    ``1 + 0.1 * N(0, 1)`` of shape (R_l, C), drawn on the CPU from
    ``generator`` in the JAX package's order (per scale and plane, the plane
    then its line) and placed on ``device``."""
    params = {}
    c = spec.n_components
    for s in range(spec.n_scales):
        rp = spec.plane_res(s)
        for k in range(3):
            params[f"plane_{s}_{k}"] = (torch.randn((rp * rp, c), generator=generator)
                                        * 0.1).to(device)
            params[f"line_{s}_{k}"] = (torch.ones((spec.line_resolution, c))
                                       + torch.randn((spec.line_resolution, c),
                                                     generator=generator) * 0.1).to(device)
    return params


def _clip01(u):
    """``clip(u, 0, 1)`` as ``minimum(maximum(u, 0), 1)``: at u = 0 or 1 its
    derivative is 1/2, as ``jnp.clip``'s under ``jax.grad``."""
    return torch.minimum(torch.maximum(u, torch.zeros_like(u)), torch.ones_like(u))


def _interp_rows_weights_1d(u, res):
    """u in [0, 1] -> (i0, i1, w1): linear interpolation rows and the weight
    of i1."""
    p = _clip01(u) * (res - 1)
    i0 = torch.clamp(torch.floor(p).long(), 0, res - 2)
    w1 = p - i0.to(p.dtype)
    return i0, i0 + 1, w1


def _plane_taps(x, axes, res):
    """Bilinear taps of one plane: 4 row ids (4, N) and weights (4, N)."""
    a, b, _ = axes
    ia0, ia1, wa = _interp_rows_weights_1d(x[..., a], res)
    ib0, ib1, wb = _interp_rows_weights_1d(x[..., b], res)
    rows = torch.stack([ia0 * res + ib0, ia0 * res + ib1, ia1 * res + ib0, ia1 * res + ib1])
    w = torch.stack([(1 - wa) * (1 - wb), (1 - wa) * wb, wa * (1 - wb), wa * wb])
    return rows, w


def _line_taps(x, axes, res):
    i0, i1, w1 = _interp_rows_weights_1d(x[..., axes[2]], res)
    return torch.stack([i0, i1]), torch.stack([1.0 - w1, w1])


def _gather_weighted(table, rows, w):
    """``sum_t w[t] * table[rows[t]]`` over the taps in order, each product
    rounded before its sum: (T, N) taps -> (N, C)."""
    acc = table[rows[0]] * w[0, :, None]
    for t in range(1, rows.shape[0]):
        acc = acc + table[rows[t]] * w[t, :, None]
    return acc


def vm_encode(params, x, spec: VMSpec):
    """The plain VM encoding: positions (..., 3) in [0, 1] -> (..., S*3*C),
    differentiable at any order by autograd (the NeuS analytic gradient's
    composed path)."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    outs = []
    for s in range(spec.n_scales):
        rp = spec.plane_res(s)
        for k, axes in enumerate(VMSpec.AXES):
            prow, pw = _plane_taps(xf, axes, rp)
            lrow, lw = _line_taps(xf, axes, spec.line_resolution)
            pf = _gather_weighted(params[f"plane_{s}_{k}"], prow, pw)
            lf = _gather_weighted(params[f"line_{s}_{k}"], lrow, lw)
            outs.append(pf * lf)
    return torch.cat(outs, dim=-1).reshape(*batch_shape, spec.n_output_dims)


@torch.no_grad()
def vm_backward_plain(params, x, ct, spec: VMSpec, with_dx=False, accumulate=torch.float32):
    """Plain version of VM2 (JAX ``_vm_fast_bwd``, :176-237) for the output
    cotangent ``ct`` (..., S*3*C): per scale and plane, the plane rows get the
    segment sums of ``w_p * (g * lf)`` and the line rows those of ``w_l * (g *
    pf)``; with ``with_dx`` the position gradient through the interpolation
    weights, each axis masked to ``0 < x < 1``. Returns (dict of table
    gradients, dx (..., 3) or None). ``accumulate``: the type the float32
    updates are summed in (float64 gives their exact sum, the card's
    reference for VM2's atomics; the gradients are then returned in it)."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3).float()
    n = xf.shape[0]
    c = spec.n_components
    ct2 = ct.reshape(n, spec.n_scales * 3, c).float()
    dparams = {}
    dx = torch.zeros_like(xf) if with_dx else None
    comp = 0
    for s in range(spec.n_scales):
        rp = spec.plane_res(s)
        for k, axes in enumerate(VMSpec.AXES):
            a, b, cax = axes
            g = ct2[:, comp]
            comp += 1
            prow, pw = _plane_taps(xf, axes, rp)
            lrow, lw = _line_taps(xf, axes, spec.line_resolution)
            ptab = params[f"plane_{s}_{k}"]
            ltab = params[f"line_{s}_{k}"]
            pf = _gather_weighted(ptab, prow, pw)
            lf = _gather_weighted(ltab, lrow, lw)
            gl = g * lf
            upd_p = (pw[..., None] * gl[None]).reshape(4 * n, c)
            dparams[f"plane_{s}_{k}"] = segment_sum_dense_sorted(
                prow.reshape(-1), upd_p.to(accumulate), rp * rp)
            gp = g * pf
            upd_l = (lw[..., None] * gp[None]).reshape(2 * n, c)
            dparams[f"line_{s}_{k}"] = segment_sum_dense_sorted(
                lrow.reshape(-1), upd_l.to(accumulate), spec.line_resolution)
            if not with_dx:
                continue
            gp_tap = (ptab[prow].float() * gl[None]).sum(-1)  # (4, N): P_corner . g*lf
            gl_tap = (ltab[lrow].float() * gp[None]).sum(-1)  # (2, N)
            pa = _clip01(xf[:, a]) * (rp - 1)
            pb = _clip01(xf[:, b]) * (rp - 1)
            wa = pa - torch.clamp(torch.floor(pa), 0, rp - 2)
            wb = pb - torch.clamp(torch.floor(pb), 0, rp - 2)
            # taps (ia0 ib0, ia0 ib1, ia1 ib0, ia1 ib1)
            dw_da = torch.stack([-(1 - wb), -wb, (1 - wb), wb]) * (rp - 1)
            dw_db = torch.stack([-(1 - wa), (1 - wa), -wa, wa]) * (rp - 1)
            rl = spec.line_resolution
            dw_dc = torch.stack([-torch.ones(n, device=xf.device),
                                 torch.ones(n, device=xf.device)]) * (rl - 1)
            for axis, dw, tap in ((a, dw_da, gp_tap), (b, dw_db, gp_tap), (cax, dw_dc, gl_tap)):
                inside = ((xf[:, axis] > 0) & (xf[:, axis] < 1)).float()
                dx[:, axis] += (dw * tap).sum(0) * inside
    out_dtype = ct.dtype if accumulate == torch.float32 else accumulate
    dparams = {k: v.to(out_dtype) for k, v in dparams.items()}
    return dparams, (dx.reshape(*batch_shape, 3).to(x.dtype) if with_dx else None)


def vm_encode_fast(params, x, spec: VMSpec):
    """First-order VM encoding: VM1 forward and VM2 backward on the card, the
    plain versions on the CPU. The tables get gradients; ``x`` gets one only
    when it requires grad."""
    tables = [params[k] for k in spec.keys()]
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in tables)):
        return _VMFast.apply(x, spec, *tables)
    return vm_forward(params, x, spec)


class _VMFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, *tables):
        ctx.save_for_backward(x, *tables)
        ctx.spec = spec
        return vm_forward(dict(zip(spec.keys(), tables)), x, spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        x, *tables = ctx.saved_tensors
        spec = ctx.spec
        dtables, dx = vm_backward(dict(zip(spec.keys(), tables)), x, dout.contiguous(), spec,
                                  with_dx=ctx.needs_input_grad[0])
        return (dx, None, *(dtables[k] for k in spec.keys()))


def vm_forward(params, x, spec: VMSpec):
    """(..., 3) -> (..., S*3*C): VM1 on CUDA tensors, the plain version on
    CPU tensors."""
    if x.device.type == "cuda":
        return vm_forward_launch(params, x, spec)
    if x.device.type == "cpu":
        with torch.no_grad():
            return vm_encode(params, x, spec)
    raise ValueError(f"vm_forward: unsupported device {x.device}")


vm_forward.launches = 0


def vm_backward(params, x, dout, spec: VMSpec, with_dx=False):
    """(dict of table gradients, dx (..., 3) or None) for the output
    cotangent ``dout``: VM2 on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cuda":
        return vm_backward_launch(params, x, dout, spec, with_dx)
    if x.device.type == "cpu":
        return vm_backward_plain(params, x, dout, spec, with_dx)
    raise ValueError(f"vm_backward: unsupported device {x.device}")


vm_backward.launches = 0


# ---------------------------------------------------------------------------
# the kernels (VM1, VM2)
# ---------------------------------------------------------------------------

_MAX_J = 3 * MAX_SCALES


class _Tables(ctypes.Structure):
    """csrc/vm_common.cuh VMTables: per plane j = 3 s + k, its plane and line
    (or their gradients) and the plane's resolution."""
    _fields_ = [("plane", ctypes.c_void_p * _MAX_J), ("line", ctypes.c_void_p * _MAX_J),
                ("plane_res", ctypes.c_int * _MAX_J)]


def check_instantiated(spec: VMSpec):
    """Raise a ValueError unless VM1 / VM2 exist for ``spec`` (a model built
    for the card calls it, so a shape without kernels is refused at build
    time)."""
    if spec.n_components not in COMPONENTS or not 1 <= spec.n_scales <= MAX_SCALES:
        raise ValueError(f"vm: no CUDA instantiation for {spec}; supported: n_components in "
                         f"{COMPONENTS}, 1 to {MAX_SCALES} scales")


def _tables(spec: VMSpec, planes, lines):
    arr = _Tables()
    for j in range(3 * spec.n_scales):
        arr.plane[j] = planes[j].data_ptr()
        arr.line[j] = lines[j].data_ptr()
        arr.plane_res[j] = spec.plane_res(j // 3)
    return arr


def _operands(name, params, x, spec: VMSpec):
    check_instantiated(spec)
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"{name}: x must be float32 (..., 3), got {tuple(x.shape)} {x.dtype}")
    tables = [params[k] for k in spec.keys()]
    if any(t.dtype != torch.float32 for t in tables):
        raise ValueError(f"{name}: the tables must be float32")
    c = spec.n_components
    shapes = []
    for j in range(3 * spec.n_scales):
        shapes += [(spec.plane_res(j // 3) ** 2, c), (spec.line_resolution, c)]
    cuda_build.check_operands(name, tables, shapes, x.device)
    return x.reshape(-1, 3).contiguous(), tables[0::2], tables[1::2]


def vm_forward_launch(params, x, spec: VMSpec):
    """Launch ``csrc/vm_fwd.cu`` (VM1) for CUDA x. With no samples it returns
    an empty output and launches nothing."""
    xf, planes, lines = _operands("vm_forward", params, x, spec)
    n = xf.shape[0]
    out = torch.empty((n, spec.n_output_dims), dtype=torch.float32, device=x.device)
    if n > 0:
        fn = cuda_build.entry("vm_fwd", "vm_fwd", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(_Tables), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(xf.data_ptr(), n, _tables(spec, planes, lines), 3 * spec.n_scales,
                    spec.n_components, spec.line_resolution, out.data_ptr(), stream)
        cuda_build.check(rc, "vm_forward", f"n_components in {COMPONENTS}")
        vm_forward.launches += 1
    return out.reshape(*x.shape[:-1], spec.n_output_dims)


def vm_backward_launch(params, x, dout, spec: VMSpec, with_dx=False):
    """Launch ``csrc/vm_bwd.cu`` (VM2) for CUDA tensors; see
    :func:`vm_backward` for the outputs. The gradients of all tables are
    views of one buffer, which the entry point zeroes before the kernel adds
    into it. With no samples it returns zeros and launches nothing."""
    xf, planes, lines = _operands("vm_backward", params, x, spec)
    n = xf.shape[0]
    if dout.dtype != torch.float32:
        raise ValueError(f"vm_backward: dout must be float32, got {dout.dtype}")
    ct = dout.reshape(n, spec.n_output_dims).contiguous()
    cuda_build.check_operands("vm_backward", (ct,), ((n, spec.n_output_dims),), x.device)
    keys = spec.keys()
    sizes = [params[k].numel() for k in keys]
    flat = torch.empty((sum(sizes),), dtype=torch.float32, device=x.device)
    grads = dict(zip(keys, (g.view_as(params[k]) for k, g in zip(keys, flat.split(sizes)))))
    dx = torch.empty((n, 3), dtype=torch.float32, device=x.device) if with_dx else None
    # the planes' terms of d x, summed per sample in plane order by the entry point
    dx_part = (torch.empty((3 * spec.n_scales, n, 3), dtype=torch.float32, device=x.device)
               if with_dx and n > 0 else None)
    if n == 0:
        flat.zero_()
        if with_dx:
            dx.zero_()
    else:
        fn = cuda_build.entry("vm_bwd", "vm_bwd", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(_Tables),
            ctypes.POINTER(_Tables), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ])
        dplanes = [grads[k] for k in keys[0::2]]
        dlines = [grads[k] for k in keys[1::2]]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(xf.data_ptr(), n, ct.data_ptr(), _tables(spec, planes, lines),
                    _tables(spec, dplanes, dlines), 3 * spec.n_scales, spec.n_components,
                    spec.line_resolution, flat.data_ptr(), flat.numel() * 4,
                    dx.data_ptr() if with_dx else None,
                    dx_part.data_ptr() if with_dx else None, stream)
        cuda_build.check(rc, "vm_backward", f"n_components in {COMPONENTS}")
        vm_backward.launches += 1
    return grads, (dx.reshape(*x.shape[:-1], 3) if with_dx else None)
