"""Multiresolution hash-grid encoding (Instant-NGP), forward and table
gradient.

Port of ``instant_nsr_pl_tpu/ops/hashgrid.py``: :class:`HashGridSpec`
(:44-153, copied field for field), :func:`hashgrid_init` (:155-169),
:func:`level_corner_indices` (:172-222), :func:`hashgrid_encode` (:458-498,
the plain version, differentiable at any order) and
:func:`hashgrid_encode_fast` (:576-765, first order). The level layout is the
JAX package's (and tcnn's):

- level ``l`` scale ``s_l = 2^(l*log2(b)) * N_min - 1``, resolution
  ``R_l = ceil(s_l) + 1``;
- a level is dense when ``R_l^3 <= 2^log2_hashmap_size`` (stride indexing,
  its size rounded up to a multiple of 8), else hashed:
  ``(x * 1) ^ (y * 2654435761) ^ (z * 805459861) mod T`` in uint32
  arithmetic;
- trilinear interpolation over the 8 corners of ``pos = x * s_l + 0.5``.

The table is row-major ``(total_params, F)`` float32: a corner's F features
are one 8-byte piece of one 32-byte sector (the JAX package's feature-major
``(F, total_params)`` layout, which served the TPU's lanes, costs F sectors a
corner on the card). A JAX table carries across transposed
(``utils/transplant.py``), its Adam moments too.

``hashgrid_encode_fast`` launches ``csrc/hashgrid_fwd.cu`` (HG1) in its
forward and ``csrc/hashgrid_bwd.cu`` (HG2) in its backward on CUDA tensors,
and the plain versions below on CPU tensors; there is no fallback from one to
the other. The JAX fast path is XLA, not Pallas: it saves the taps (indices,
weights, gathered rows) for a backward of two-sort segment sums and bf16
one-hot matmuls. Here the backward recomputes the taps (HG2 re-hashes; the
table rows are read again only for the position gradient) and scatters
``w * ct`` with float32 vector atomics straight into the (T, F) gradient,
merging equal rows within a warp first: saving the taps at the bench shape
would hold 16 levels x 8 corners x 262,144 samples x 16 B = 537 MB per step.

Rounding: ``pos = x * s + 0.5`` is rounded once, as a fused multiply-add:
the JAX package's jitted code contracts it (eagerly it does not, and then the
weights differ in the last bit). ``floor(pos)`` picks the cell, so a
different rounding could move a sample on a cell boundary to the
neighbouring cell; the tests hold the taps equal away from boundaries. Each
corner's weight is ``(p_x * p_y) * p_z``, and the features sum the corners in
order 0..7 as fused multiply-adds, as the jitted JAX code and HG1 (explicit
``fmaf``, ``--fmad=false``) do: the plain forward equals both to the bit.

Tap dedup (the spec's ``dedup_group`` / ``dedup_step``, the JAX package's
27-point lattice gather for coarse levels) computes the same function as the
per-sample taps. The port keeps the fields and ``dedup_group_sizes`` so a
config means the same in both packages, and always computes per-sample taps.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from instant_nsr_pl_tpu_torch.ops import cuda_build

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
MAX_LEVELS = 32  # the kernels' per-level parameter array


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static description of a hash-grid encoding."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.447269237440378
    n_input_dims: int = 3
    # per-group tap dedup of the JAX package (0 = per-sample taps); the port
    # computes per-sample taps whatever these say
    dedup_group: int = 0
    dedup_step: float = 0.0

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def scales(self) -> tuple[float, ...]:
        return tuple(
            math.exp2(l * math.log2(self.per_level_scale)) * self.base_resolution - 1.0
            for l in range(self.n_levels)
        )

    @property
    def resolutions(self) -> tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.scales)

    @property
    def level_sizes(self) -> tuple[int, ...]:
        # tcnn rounds dense levels up to a multiple of 8
        return tuple(min(-(-r**self.n_input_dims // 8) * 8, self.table_size)
                     for r in self.resolutions)

    @property
    def level_hashed(self) -> tuple[bool, ...]:
        return tuple(r**self.n_input_dims > self.table_size for r in self.resolutions)

    @property
    def level_offsets(self) -> tuple[int, ...]:
        offs, acc = [], 0
        for s in self.level_sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    @property
    def total_params(self) -> int:
        return sum(self.level_sizes)

    @property
    def dedup_group_sizes(self) -> tuple[int, ...]:
        """Per-level dedup block size of the JAX package (0 = per-sample
        taps): the largest g >= 4 dividing ``dedup_group`` with ``g *
        dedup_step * scale_l <= 1``, so a block's samples share one cell cube
        of the level."""
        if self.dedup_group < 4 or self.dedup_step <= 0.0:
            return tuple(0 for _ in range(self.n_levels))
        out = []
        for s in self.scales:
            g = self.dedup_group
            while g >= 4 and (g * self.dedup_step * s > 1.0 or self.dedup_group % g):
                g //= 2
            out.append(g if g >= 4 else 0)
        return tuple(out)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @classmethod
    def from_config(cls, config, n_input_dims=3) -> "HashGridSpec":
        return cls(
            n_levels=int(config["n_levels"]),
            n_features_per_level=int(config["n_features_per_level"]),
            log2_hashmap_size=int(config["log2_hashmap_size"]),
            base_resolution=int(config["base_resolution"]),
            per_level_scale=float(config["per_level_scale"]),
            n_input_dims=n_input_dims,
        )


def hashgrid_init(generator: torch.Generator, spec: HashGridSpec, device=None):
    """The (total_params, F) float32 table, U(-1e-4, 1e-4) (tcnn's default),
    drawn on the CPU from ``generator`` and placed on ``device``. The values
    are drawn feature-major, as before the table became row-major, so a seed
    gives the same table in either layout."""
    t = torch.rand((spec.n_features_per_level, spec.total_params), generator=generator)
    return (t * 2e-4 - 1e-4).T.contiguous().to(device)


def _level_pos(spec: HashGridSpec, xt, level: int):
    """float32 ``x * s + 0.5`` rounded once (the product is exact in float64)."""
    return (xt.double() * float(torch.tensor(spec.scales[level], dtype=torch.float32))
            + 0.5).float()


def level_corner_indices(spec: HashGridSpec, xt, level: int):
    """Global table rows and trilinear weights of one level's 8 corners.

    Args:
      xt: (3, N) positions in [0, 1], coordinate-major.
    Returns:
      idx: (8, N) int64 rows of the (total_params, F) table; w: (8, N) float32.
    """
    res = spec.resolutions[level]
    size = spec.level_sizes[level]
    hashed = spec.level_hashed[level]
    pos = _level_pos(spec, xt, level)  # (3, N)
    grid = torch.floor(pos)
    frac = pos - grid
    gi = grid.long()
    idx_list, w_list = [], []
    for c in range(8):
        bits = (c & 1, (c >> 1) & 1, (c >> 2) & 1)
        cu = [torch.clamp(gi[d] + bits[d], 0, res - 1) for d in range(3)]
        if hashed:  # uint32 products, wrapped mod 2^32 before the XOR
            local = ((cu[0] * _PRIMES[0]) & _U32) ^ ((cu[1] * _PRIMES[1]) & _U32) \
                ^ ((cu[2] * _PRIMES[2]) & _U32)
            local = local % size
        else:
            local = cu[0] + cu[1] * res + cu[2] * (res * res)
        idx_list.append(local + spec.level_offsets[level])
        w = frac[0] if bits[0] else 1.0 - frac[0]
        for d in (1, 2):
            w = w * (frac[d] if bits[d] else 1.0 - frac[d])
        w_list.append(w)
    return torch.stack(idx_list), torch.stack(w_list)


def _corner_sum(rows, w):
    """sum_c rows[:, c] * w[c] over the 8 corners in order, as fused
    multiply-adds after the first product (the JAX package's jitted code
    contracts its corner sum so): (F, 8, N) x (8, N) -> (F, N). Each step's
    product is exact in float64 and its sum rounds once to float32."""
    acc = rows[:, 0] * w[0]
    for c in range(1, 8):
        acc = (acc.double() + rows[:, c].double() * w[c].double()).float()
    return acc


def hashgrid_encode(table, x, spec: HashGridSpec, level_mask=None):
    """The plain hash encoding, differentiable at any order by autograd (the
    role of the JAX package's ``hashgrid_encode``).

    Args:
      table: (total_params, F) float32.
      x: (..., 3) positions in [0, 1].
      level_mask: optional (L,) float mask multiplied per level.
    Returns:
      (..., L*F) features, level-major.
    """
    batch_shape = x.shape[:-1]
    xt = x.reshape(-1, spec.n_input_dims).T
    outs = []
    for level in range(spec.n_levels):
        idx, w = level_corner_indices(spec, xt, level)
        feat = _corner_sum(table.T[:, idx], w.to(table.dtype))  # (F, N)
        if level_mask is not None:
            feat = feat * level_mask[level].to(feat.dtype)
        outs.append(feat)
    out = torch.cat(outs, dim=0)  # (L*F, N)
    return out.T.reshape(*batch_shape, spec.n_output_dims)


def _check_spec(spec: HashGridSpec, table):
    if spec.n_input_dims != 3 or spec.n_levels > MAX_LEVELS:
        raise ValueError(f"hashgrid: 3-D inputs and at most {MAX_LEVELS} levels, got {spec}")
    expect = (spec.total_params, spec.n_features_per_level)
    if tuple(table.shape) != expect:
        raise ValueError(f"hashgrid: table {tuple(table.shape)} != {expect}")


def hashgrid_encode_fast(table, x, spec: HashGridSpec, level_mask=None):
    """First-order hash encoding: HG1 forward and HG2 backward on the card,
    the plain versions on the CPU. ``x`` gets a cotangent only when it
    requires grad; ``level_mask`` gets none (as in the JAX custom VJP)."""
    _check_spec(spec, table)
    if torch.is_grad_enabled() and (table.requires_grad or x.requires_grad):
        return _HashGridFast.apply(table, x, spec, level_mask)
    return hashgrid_forward(table, x, spec, level_mask)


class _HashGridFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, spec, level_mask):
        ctx.save_for_backward(table, x, level_mask)
        ctx.spec = spec
        return hashgrid_forward(table, x, spec, level_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        table, x, level_mask = ctx.saved_tensors
        dtable, dx = hashgrid_backward(table, x, dout.contiguous(), ctx.spec, level_mask,
                                       with_dx=ctx.needs_input_grad[1])
        return dtable, dx, None, None


def hashgrid_forward(table, x, spec: HashGridSpec, level_mask=None):
    """(..., 3) -> (..., L*F) features: HG1 on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cuda":
        return hashgrid_forward_launch(table, x, spec, level_mask)
    if x.device.type == "cpu":
        with torch.no_grad():
            return hashgrid_encode(table, x, spec, level_mask)
    raise ValueError(f"hashgrid_forward: unsupported device {x.device}")


hashgrid_forward.launches = 0


def hashgrid_backward(table, x, dout, spec: HashGridSpec, level_mask=None, with_dx=False):
    """The table gradient (total_params, F) and, with ``with_dx``, the
    position gradient (..., 3) (else None) for the output cotangent ``dout``
    (..., L*F): HG2 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return hashgrid_backward_launch(table, x, dout, spec, level_mask, with_dx)
    if x.device.type == "cpu":
        return hashgrid_backward_plain(table, x, dout, spec, level_mask, with_dx)
    raise ValueError(f"hashgrid_backward: unsupported device {x.device}")


hashgrid_backward.launches = 0


# the corner bit pattern (8, 3) and the per-dimension signs of d w / d frac
_CORNER_BITS = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                            dtype=torch.float32)


@torch.no_grad()
def hashgrid_backward_plain(table, x, dout, spec: HashGridSpec, level_mask=None,
                            with_dx=False):
    """Plain version of HG2: per level, ``index_add_`` of the 8 corners'
    ``w * ct`` into the table gradient; with ``with_dx`` the position
    gradient ``sum_c dw_c/dx * (T[idx_c] . ct)`` (JAX ``_level_dx``)."""
    batch_shape = x.shape[:-1]
    xt = x.reshape(-1, 3).T.float()
    n = xt.shape[1]
    f = spec.n_features_per_level
    ct = dout.reshape(n, spec.n_levels, f).float()
    dtable = torch.zeros_like(table, dtype=torch.float32)
    dx_t = torch.zeros_like(xt) if with_dx else None
    bits = _CORNER_BITS.to(x.device)[:, :, None]  # (8, 3, 1)
    for level in range(spec.n_levels):
        g_l = ct[:, level]  # (N, F)
        if level_mask is not None:
            g_l = g_l * level_mask[level].float()
        idx, w = level_corner_indices(spec, xt, level)
        upd = (w[:, :, None] * g_l[None]).reshape(8 * n, f)
        dtable.index_add_(0, idx.reshape(-1), upd)
        if with_dx:
            rows = table.T[:, idx].float()  # (F, 8, N)
            tg = (rows * g_l.T[:, None, :]).sum(0)  # (8, N)
            s = float(torch.tensor(spec.scales[level], dtype=torch.float32))
            pos = _level_pos(spec, xt, level)
            frac = pos - torch.floor(pos)
            p = bits * frac[None] + (1.0 - bits) * (1.0 - frac[None])  # (8, 3, N)
            prod_excl = torch.stack([p[:, 1] * p[:, 2], p[:, 0] * p[:, 2], p[:, 0] * p[:, 1]],
                                    dim=1)
            dx_t += (((bits * 2.0 - 1.0) * prod_excl * tg[:, None, :]).sum(0)) * s
    dx = dx_t.T.reshape(*batch_shape, 3).to(x.dtype) if with_dx else None
    return dtable.to(table.dtype), dx


# ---------------------------------------------------------------------------
# the kernels (HG1, HG2)
# ---------------------------------------------------------------------------


class _Level(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float), ("res", ctypes.c_uint32),
                ("size", ctypes.c_uint32), ("offset", ctypes.c_uint32),
                ("hashed", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def level_params(spec: HashGridSpec):
    """The kernels' per-level constants: scale (float32), resolution, size,
    offset and whether the level is hashed (built once per spec: the
    properties recompute every level's layout on each access)."""
    arr = (_Level * MAX_LEVELS)()
    scales, res, sizes = spec.scales, spec.resolutions, spec.level_sizes
    offsets, hashed = spec.level_offsets, spec.level_hashed
    for l in range(spec.n_levels):
        arr[l] = _Level(scales[l], res[l], sizes[l], offsets[l], int(hashed[l]))
    return arr


def _operands(name, table, x, spec, level_mask):
    if table.dtype != torch.float32 or x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"{name}: table and x must be float32 and x (..., 3), got "
                         f"{table.dtype} {tuple(x.shape)} {x.dtype}")
    _check_spec(spec, table)
    xf = x.reshape(-1, 3).contiguous()
    operands, shapes = [table], [(spec.total_params, spec.n_features_per_level)]
    if level_mask is not None:
        level_mask = level_mask.float().contiguous()
        operands.append(level_mask)
        shapes.append((spec.n_levels,))
    cuda_build.check_operands(name, operands, shapes, x.device)
    return xf, level_mask


def hashgrid_forward_launch(table, x, spec: HashGridSpec, level_mask=None):
    """Launch ``csrc/hashgrid_fwd.cu`` (HG1) for CUDA x."""
    xf, mask = _operands("hashgrid_forward", table, x, spec, level_mask)
    n = xf.shape[0]
    f = spec.n_features_per_level
    out = torch.empty((n, spec.n_levels * f), dtype=torch.float32, device=x.device)
    fn = cuda_build.entry("hashgrid_fwd", "hashgrid_fwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Level), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(xf.data_ptr(), n, table.data_ptr(), spec.n_levels, f, level_params(spec),
                mask.data_ptr() if mask is not None else None, out.data_ptr(), stream)
    cuda_build.check(rc, "hashgrid_forward", "n_features_per_level in {1, 2, 4, 8}")
    hashgrid_forward.launches += 1
    return out.reshape(*x.shape[:-1], spec.n_levels * f)


def hashgrid_backward_launch(table, x, dout, spec: HashGridSpec, level_mask=None,
                             with_dx=False):
    """Launch ``csrc/hashgrid_bwd.cu`` (HG2) for CUDA tensors; see
    :func:`hashgrid_backward` for the outputs. The kernel scatters into the
    zeroed (T, F) gradient. With no samples it returns zeros and launches
    nothing."""
    xf, mask = _operands("hashgrid_backward", table, x, spec, level_mask)
    n = xf.shape[0]
    f = spec.n_features_per_level
    if dout.dtype != torch.float32:
        raise ValueError(f"hashgrid_backward: dout must be float32, got {dout.dtype}")
    ct = dout.reshape(n, spec.n_levels * f).contiguous()
    cuda_build.check_operands("hashgrid_backward", (ct,), ((n, spec.n_levels * f),), x.device)
    dx = torch.empty((n, 3), dtype=torch.float32, device=x.device) if with_dx else None
    dtable = torch.zeros_like(table)
    if n == 0:
        return dtable, (dx.reshape(*x.shape[:-1], 3) if with_dx else None)
    fn = cuda_build.entry("hashgrid_bwd", "hashgrid_bwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_Level), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(xf.data_ptr(), n, ct.data_ptr(), table.data_ptr(), spec.n_levels, f,
                level_params(spec), mask.data_ptr() if mask is not None else None,
                dtable.data_ptr(), dx.data_ptr() if with_dx else None, stream)
    cuda_build.check(rc, "hashgrid_backward", "n_features_per_level in {1, 2, 4, 8}")
    hashgrid_backward.launches += 1
    return dtable, (dx.reshape(*x.shape[:-1], 3) if with_dx else None)
