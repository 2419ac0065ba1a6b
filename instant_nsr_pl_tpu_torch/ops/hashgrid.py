"""Multiresolution hash-grid encoding (Instant-NGP), forward and table
gradient, and the encoding with its position Jacobian.

Port of ``instant_nsr_pl_tpu/ops/hashgrid.py``: :class:`HashGridSpec`
(:44-153, copied field for field), :func:`hashgrid_init` (:155-169),
:func:`level_corner_indices` (:172-222), the 27-point lattice of the tap
dedup (:221-455, :data:`LATTICE27` to :func:`level_lattice_jac_bwd`),
:func:`hashgrid_encode` (:458-498, the plain version, differentiable at any
order), :func:`hashgrid_encode_fast` (:576-765, first order) and
:func:`hashgrid_encode_with_jac` (:767-957, first order: the features and
their analytic Jacobian for the NeuS SDF's gradient). The level layout is the
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
and ``hashgrid_encode_with_jac`` ``csrc/hashgrid_jac_fwd.cu`` (HG3) and
``csrc/hashgrid_jac_bwd.cu`` (HG4); on CPU tensors both run the plain
versions below, and there is no fallback from one to the other. The JAX
fast paths are XLA, not Pallas: they save the taps (indices, weights,
gathered rows) for a backward of two-sort segment sums and bf16 one-hot
matmuls. Here the backwards recompute the taps (HG2 / HG4 re-hash; the
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

Tap dedup (the spec's ``dedup_group`` / ``dedup_step``, which the renderer
sets when its group-compacted march guarantees aligned single-ray blocks of
``dedup_group`` samples): a level with ``dedup_group_sizes[l] = g > 0`` reads
one 27-point lattice of rows per aligned block of g samples, anchored at
``floor(min over the block of pos)``, and weights each sample's rows by the
tent product ``prod_d max(0, 1 - |pos_d - anchor_d - o_d|)`` (the same
trilinear function: the tents vanish off the sample's 8 corners), as the JAX
package's ``_level_lattice_*`` do; the other levels keep the per-sample
taps. Such levels are a prefix of the levels (g shrinks as the scale grows).
On CUDA tensors ``csrc/hashgrid_lattice_fwd.cu`` (HG5 forward, HG7 with the
Jacobian) and ``csrc/hashgrid_lattice_bwd.cu`` (HG6, HG8: 27 row updates a
block instead of 8g) run those levels after HG1-HG4, which skip them. The
plain ``hashgrid_encode`` (the autodiff path) stays per-sample, as in JAX.
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
    # per-group tap dedup (0 = per-sample taps everywhere): the aligned block
    # size the march guarantees, and the per-axis position step bound in
    # [0, 1] coordinates (dedup_group_sizes)
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
    idx, w, _ = _level_taps(spec, xt, level)
    return idx, w


def _level_taps(spec: HashGridSpec, xt, level: int):
    """:func:`level_corner_indices` and the (3, N) cell fractions."""
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
    return torch.stack(idx_list), torch.stack(w_list), frac


def _corner_sum(rows, w):
    """sum_c rows[:, c] * w[c] over the 8 corners in order, as fused
    multiply-adds after the first product (the JAX package's jitted code
    contracts its corner sum so): (F, 8, N) x (8, N) -> (F, N). Each step's
    product is exact in float64 and its sum rounds once to float32."""
    acc = rows[:, 0] * w[0]
    for c in range(1, 8):
        acc = (acc.double() + rows[:, c].double() * w[c].double()).float()
    return acc


# ---------------------------------------------------------------------------
# the 27-point lattice of the tap dedup (JAX ops/hashgrid.py:221-455)
# ---------------------------------------------------------------------------

# the 27 lattice offsets of the 2x2x2 cell cube, x fastest: (27, 3) int64
LATTICE27 = torch.tensor([[i % 3, (i // 3) % 3, i // 9] for i in range(27)])
_LATTICE_OTHERS = ((1, 2), (0, 2), (0, 1))
# third[d][e]: the axis that is neither d nor e (the diagonal is unused)
_THIRD = ((0, 2, 1), (2, 0, 0), (1, 0, 0))


def _level_index(spec: HashGridSpec, level: int, cu):
    """Level-local rows of the clamped per-axis cells ``cu`` (3 int64
    tensors): the uint32 hash wrapped mod 2^32 before the XOR, or the dense
    stride."""
    if spec.level_hashed[level]:
        local = ((cu[0] * _PRIMES[0]) & _U32) ^ ((cu[1] * _PRIMES[1]) & _U32) \
            ^ ((cu[2] * _PRIMES[2]) & _U32)
        return local % spec.level_sizes[level]
    res = spec.resolutions[level]
    return cu[0] + cu[1] * res + cu[2] * (res * res)


def level_lattice_gather(table, xt, spec: HashGridSpec, level: int, g: int):
    """The 27-point lattice of each aligned block of ``g`` samples on one
    dedup level (JAX ``_level_lattice_gather``, :226).

    Args:
      table: (total_params, F).
      xt: (3, N) positions in [0, 1], N divisible by g.
    Returns:
      idx: (27, B) int64 global rows (B = N // g), clamped like the
        per-sample corners (the weights stay attached to the UNCLAMPED
        lattice point, so colliding clamped rows sum as clamped corners do);
      gvals: (B, 27, F) the rows (the JAX package's is (F, 27, B));
      pos: (3, N) float32 grid positions; a: (3, B) int64 anchors,
        ``floor(min over the block of pos)``.
    """
    n = xt.shape[1]
    assert n % g == 0, (n, g)
    b = n // g
    pos = _level_pos(spec, xt, level)
    a = torch.floor(pos.reshape(3, b, g).amin(dim=2)).long()
    offs = LATTICE27.to(xt.device)
    rmax = spec.resolutions[level] - 1
    cu = [torch.clamp(a[d][None, :] + offs[:, d][:, None], 0, rmax) for d in range(3)]
    idx = _level_index(spec, level, cu) + spec.level_offsets[level]  # (27, B)
    return idx, table[idx.T], pos, a


def lattice_axis_tents(pos, a, g: int):
    """Per-axis tents of every sample against its block's lattice (JAX
    ``_lattice_axis_tents``, :274): w3 (3, 3, N) = ``max(0, 1 - |t_d - o|)``
    for o in {0, 1, 2}, and t (3, N) = pos - anchor, in float32."""
    t = pos - a.repeat_interleave(g, dim=1).to(pos.dtype)
    offs3 = torch.arange(3, dtype=pos.dtype, device=pos.device)[None, :, None]
    return torch.clamp(1.0 - torch.abs(t[:, None, :] - offs3), min=0.0), t


def lattice_w27(w3):
    """The tent product of each lattice point, (27, N): ``(w_x * w_y) * w_z``
    (JAX ``_lattice_w27``, :291)."""
    off = LATTICE27.to(w3.device)
    return w3[0, off[:, 0]] * w3[1, off[:, 1]] * w3[2, off[:, 2]]


def lattice_axis_dtents(t):
    """d tent(t_d - o) / d pos_d, (3, 3, N): +1 on [-1, 0), -1 on [0, 1), 0
    elsewhere, right-continuous, so that at an integer ``t`` the derivative is
    the per-sample path's right difference (JAX ``_lattice_axis_dtents``,
    :296)."""
    offs3 = torch.arange(3, dtype=t.dtype, device=t.device)[None, :, None]
    u = t[:, None, :] - offs3
    one = torch.ones_like(u)
    return torch.where((u >= -1.0) & (u < 0.0), one,
                       torch.where((u >= 0.0) & (u < 1.0), -one, torch.zeros_like(u)))


def lattice_wd27(w3, dw3, d: int):
    """d(tent product) / d pos_d per lattice point, (27, N), grid units:
    ``(dw_d * w_e1) * w_e2`` (JAX ``_lattice_wd27``, :316)."""
    off = LATTICE27.to(w3.device)
    e1, e2 = _LATTICE_OTHERS[d]
    return dw3[d, off[:, d]] * w3[e1, off[:, e1]] * w3[e2, off[:, e2]]


def _lattice_sum(rows, w):
    """sum_j rows[:, j] * w[j] over the 27 lattice points in order, each
    product and sum rounded once (the kernels' order): (N, 27, F) x (27, N)
    -> (N, F)."""
    acc = torch.zeros_like(rows[:, 0])
    for j in range(27):
        acc = acc + rows[:, j] * w[j][:, None]
    return acc


def _block_sum(w, ct, b: int, g: int):
    """sum over each block's g samples, in order, of ``w * ct``: (27, N) x
    (N, F) -> (27, B, F)."""
    wb, cb = w.reshape(27, b, g), ct.reshape(b, g, -1)
    acc = torch.zeros((27, b, cb.shape[-1]), dtype=ct.dtype, device=ct.device)
    for k in range(g):
        acc = acc + wb[:, :, k, None] * cb[None, :, k, :]
    return acc


def _row_dots(gvals, ct, g: int):
    """(T[row_j] . ct) per lattice point and sample, (27, N): the features
    summed in order."""
    grep = gvals.repeat_interleave(g, dim=0)  # (N, 27, F)
    acc = torch.zeros_like(grep[:, :, 0])
    for f in range(grep.shape[-1]):
        acc = acc + grep[:, :, f] * ct[:, None, f]
    return acc.T


def _point_sum(terms):
    """sum over the 27 lattice points, in order, of (27, N) terms -> (N,)."""
    acc = torch.zeros_like(terms[0])
    for j in range(27):
        acc = acc + terms[j]
    return acc


def level_lattice_feat(table, xt, spec: HashGridSpec, level: int, g: int):
    """Features of one dedup level, (F, N), and its lattice residuals (idx,
    gvals, a) (JAX ``_level_lattice_feat``, :323): the 27 points' rows times
    their tent products, summed in lattice order."""
    idx, gvals, pos, a = level_lattice_gather(table, xt, spec, level, g)
    w27 = lattice_w27(lattice_axis_tents(pos, a, g)[0])
    feat = _lattice_sum(gvals.repeat_interleave(g, dim=0), w27.to(table.dtype))
    return feat.T, (idx, gvals, a)


def level_lattice_bwd(spec: HashGridSpec, xt, level: int, g: int, idx, gvals, a, ct_l):
    """Backward of one dedup level from its lattice residuals (JAX
    ``_level_lattice_bwd``, :333).

    Args:
      ct_l: (N, F) float32 cotangent of this level's features.
    Returns:
      local_idx (27*B,) int64 level-local rows; wg (27*B, F) their updates,
      each the sum over the block's samples of tent product times cotangent;
      dx_t (3, N) the position cotangent, ``s * sum_j (T[row_j] . ct) *
      d(tent product)/d pos_d``.
    """
    s = _scale32(spec, level)
    n = xt.shape[1]
    b = n // g
    pos = _level_pos(spec, xt, level)
    w3, t = lattice_axis_tents(pos, a, g)
    wg = _block_sum(lattice_w27(w3), ct_l, b, g).reshape(27 * b, -1)
    local_idx = (idx - spec.level_offsets[level]).reshape(27 * b)
    tg = _row_dots(gvals.float(), ct_l, g)
    dw3 = lattice_axis_dtents(t)
    dx_t = torch.stack([_point_sum(tg * lattice_wd27(w3, dw3, d)) for d in range(3)]) * s
    return local_idx, wg, dx_t


def level_lattice_feat_jac(table, xt, spec: HashGridSpec, level: int, g: int):
    """Features (F, N) and their position Jacobian (3, F, N) in world units
    of one dedup level from one lattice gather, plus the residuals (idx,
    gvals, a) (JAX ``_level_lattice_feat_jac``, :370)."""
    idx, gvals, pos, a = level_lattice_gather(table, xt, spec, level, g)
    w3, t = lattice_axis_tents(pos, a, g)
    dw3 = lattice_axis_dtents(t)
    grep = gvals.repeat_interleave(g, dim=0)
    feat = _lattice_sum(grep, lattice_w27(w3).to(table.dtype))
    s = _scale32(spec, level)
    jac = torch.stack([_lattice_sum(grep.float(), lattice_wd27(w3, dw3, d)).T
                       for d in range(3)]) * s
    return feat.T, jac, (idx, gvals, a)


def level_lattice_jac_bwd(spec: HashGridSpec, xt, level: int, g: int, idx, gvals, a, ct_f,
                          ct_j):
    """Second-order backward of one dedup level (JAX
    ``_level_lattice_jac_bwd``, :391): cotangents ct_f (N, F) and ct_j (3, N,
    F) -> (local_idx (27*B,), wg (27*B, F), dx_t (3, N)). The updates are
    ``sum w27 ct_f + s sum wd27_0 ct_j[0] + s sum wd27_1 ct_j[1] + s sum
    wd27_2 ct_j[2]`` in that order; d x the feature cotangent through the
    tent product's gradient plus the Jacobian cotangent through its mixed
    second derivatives ``dtent_e dtent_d tent_third`` (e != d)."""
    s = _scale32(spec, level)
    n = xt.shape[1]
    b = n // g
    pos = _level_pos(spec, xt, level)
    w3, t = lattice_axis_tents(pos, a, g)
    dw3 = lattice_axis_dtents(t)
    wd27 = [lattice_wd27(w3, dw3, d) for d in range(3)]
    wg = _block_sum(lattice_w27(w3), ct_f, b, g)
    for d in range(3):
        wg = wg + s * _block_sum(wd27[d], ct_j[d], b, g)
    local_idx = (idx - spec.level_offsets[level]).reshape(27 * b)
    gf = gvals.float()
    tg_f = _row_dots(gf, ct_f, g)
    dx_parts = [s * _point_sum(tg_f * wd27[d]) for d in range(3)]
    tg_j = [_row_dots(gf, ct_j[e], g) for e in range(3)]
    off = LATTICE27.to(xt.device)
    for d in range(3):
        acc = torch.zeros_like(dx_parts[d])
        for e in range(3):
            if e == d:
                continue
            third = _THIRD[d][e]
            d2 = dw3[e, off[:, e]] * dw3[d, off[:, d]] * w3[third, off[:, third]]
            acc = acc + _point_sum(d2 * tg_j[e])
        dx_parts[d] = dx_parts[d] + (s * s) * acc
    return local_idx, wg.reshape(27 * b, -1), torch.stack(dx_parts)


def lattice_cover_ok(spec: HashGridSpec, x) -> bool:
    """Whether positions x (..., 3) meet the lattice's premise on every dedup
    level of ``spec``: each level's block size divides the sample count, and
    every sample of an aligned block lies within 2 cells of its block's
    anchor per axis (``0 <= pos - anchor < 2``), so its 8 corners are
    lattice points. A check for tests and the card script, not for the
    step."""
    xt = x.reshape(-1, 3).T.float()
    n = xt.shape[1]
    for level, g in enumerate(spec.dedup_group_sizes):
        if not g:
            continue
        if n % g:
            return False
        pos = _level_pos(spec, xt, level)
        a = torch.floor(pos.reshape(3, n // g, g).amin(dim=2))
        t = pos - a.repeat_interleave(g, dim=1)
        if not bool(((t >= 0.0) & (t < 2.0)).all()):
            return False
    return True


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
    """(..., 3) -> (..., L*F) features: HG1 (and HG5 on the dedup levels) on
    CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return hashgrid_forward_launch(table, x, spec, level_mask)
    if x.device.type == "cpu":
        return hashgrid_forward_plain(table, x, spec, level_mask)
    raise ValueError(f"hashgrid_forward: unsupported device {x.device}")


@torch.no_grad()
def hashgrid_forward_plain(table, x, spec: HashGridSpec, level_mask=None, lattice_only=False):
    """Plain version of HG1 and HG5 (JAX ``_encode_with_taps``, :584): the
    dedup levels of ``spec`` from their block lattices
    (:func:`level_lattice_feat`), the others from their 8 corners (zeros with
    ``lattice_only``, HG5's plain version); each level times its mask.
    Without dedup levels it equals :func:`hashgrid_encode` to the bit."""
    batch_shape = x.shape[:-1]
    xt = x.reshape(-1, spec.n_input_dims).T
    outs = []
    for level, g in enumerate(spec.dedup_group_sizes):
        if g:
            feat, _ = level_lattice_feat(table, xt, spec, level, g)
        elif lattice_only:
            feat = table.new_zeros((spec.n_features_per_level, xt.shape[1]))
        else:
            idx, w = level_corner_indices(spec, xt, level)
            feat = _corner_sum(table.T[:, idx], w.to(table.dtype))
        if level_mask is not None:
            feat = feat * level_mask[level].to(feat.dtype)
        outs.append(feat)
    return torch.cat(outs, dim=0).T.reshape(*batch_shape, spec.n_output_dims)


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
                            with_dx=False, accumulate=torch.float32, lattice_only=False):
    """Plain version of HG2 and HG6 (JAX ``_encode_fast_bwd``, :652): per
    level, ``index_add_`` of the 8 corners' ``w * ct`` (a dedup level: of
    its lattice points' block sums, :func:`level_lattice_bwd`) into the table
    gradient; with ``with_dx`` the position gradient ``sum_c dw_c/dx * (T[idx_c]
    . ct)`` (JAX ``_level_dx``), the per-sample levels' terms summed first and
    the dedup levels' after them, as the JAX package and the kernels sum
    them. ``accumulate``: the type the float32 updates are summed in
    (float64 gives their exact sum, the card's reference for the atomics;
    the table gradient is then returned in it). ``lattice_only``: the dedup
    levels' rows and terms alone (HG6's plain version)."""
    batch_shape = x.shape[:-1]
    xt = x.reshape(-1, 3).T.float()
    n = xt.shape[1]
    f = spec.n_features_per_level
    ct = dout.reshape(n, spec.n_levels, f).float()
    dtable = torch.zeros_like(table, dtype=accumulate)
    dx_t = torch.zeros_like(xt) if with_dx else None
    bits = _CORNER_BITS.to(x.device)[:, :, None]  # (8, 3, 1)
    groups = spec.dedup_group_sizes
    for level in [l for l in range(spec.n_levels) if not groups[l] and not lattice_only] + [
            l for l in range(spec.n_levels) if groups[l]]:
        g_l = ct[:, level]  # (N, F)
        if level_mask is not None:
            g_l = g_l * level_mask[level].float()
        if groups[level]:
            g = groups[level]
            idx, gvals, _, a = level_lattice_gather(table, xt, spec, level, g)
            li, wg, dxl = level_lattice_bwd(spec, xt, level, g, idx, gvals, a, g_l)
            dtable.index_add_(0, li + spec.level_offsets[level], wg.to(accumulate))
            if with_dx:
                dx_t += dxl
            continue
        idx, w = level_corner_indices(spec, xt, level)
        upd = (w[:, :, None] * g_l[None]).reshape(8 * n, f)
        dtable.index_add_(0, idx.reshape(-1), upd.to(accumulate))
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
    return (dtable.to(table.dtype) if accumulate == torch.float32 else dtable), dx


# ---------------------------------------------------------------------------
# features with their position Jacobian (HG3 forward, HG4 backward)
# ---------------------------------------------------------------------------


def _scale32(spec: HashGridSpec, level: int) -> float:
    """Level ``level``'s scale rounded to float32, as the kernels read it."""
    return float(torch.tensor(spec.scales[level], dtype=torch.float32))


def _corner_partials(frac, s: float):
    """d w_c / d x_d in world units, (8, 3, N): sign_cd times the product of
    the other two axes' tents p times s (JAX ``_jac_weights``), and the tents
    p (8, 3, N) with p_cd = frac_d where corner c sets bit d, else 1 - frac_d."""
    bits = _CORNER_BITS.to(frac.device)[:, :, None]  # (8, 3, 1)
    p = bits * frac[None] + (1.0 - bits) * (1.0 - frac[None])
    prod_excl = torch.stack([p[:, 1] * p[:, 2], p[:, 0] * p[:, 2], p[:, 0] * p[:, 1]], dim=1)
    return (bits * 2.0 - 1.0) * prod_excl * s, p


@torch.no_grad()
def hashgrid_jac_forward_plain(table, x, spec: HashGridSpec, level_mask=None,
                               lattice_only=False):
    """Plain version of HG3 and HG7: the features (..., L*F), equal to
    :func:`hashgrid_forward_plain`'s to the bit, and their position Jacobian
    (3, ..., L*F), ``jac[d] = sum_c dw_cd * T[row_c]`` summed over the corners
    in order 0..7 with each product and sum rounded once (JAX
    ``_encode_jac_fwd_impl``, :797; its einsum sums in XLA's order); a dedup
    level's from its block lattices (:func:`level_lattice_feat_jac`).
    ``lattice_only``: the other levels' columns zero (HG7's plain version)."""
    batch_shape = x.shape[:-1]
    xt = x.reshape(-1, 3).T
    feats, jacs = [], []
    f = spec.n_features_per_level
    for level, g in enumerate(spec.dedup_group_sizes):
        if g:  # a dedup level: from its block lattices (HG7)
            feat, jac, _ = level_lattice_feat_jac(table, xt, spec, level, g)
        elif lattice_only:
            feat, jac = table.new_zeros((f, xt.shape[1])), table.new_zeros((3, f, xt.shape[1]))
        else:
            idx, w, frac = _level_taps(spec, xt, level)
            rows = table.T[:, idx]  # (F, 8, N)
            feat = _corner_sum(rows, w.to(table.dtype))  # (F, N)
            dw, _ = _corner_partials(frac, _scale32(spec, level))  # (8, 3, N)
            jac = dw[0][:, None] * rows[None, :, 0]  # (3, F, N)
            for c in range(1, 8):
                jac = jac + dw[c][:, None] * rows[None, :, c]
        if level_mask is not None:
            m = level_mask[level].to(feat.dtype)
            feat, jac = feat * m, jac * m
        feats.append(feat)
        jacs.append(jac)
    lf = spec.n_output_dims
    feat = torch.cat(feats, dim=0).T.reshape(*batch_shape, lf)
    jac = torch.cat(jacs, dim=1).transpose(1, 2).reshape(3, *batch_shape, lf)
    return feat, jac


@torch.no_grad()
def hashgrid_jac_backward_plain(table, x, ct_feat, ct_jac, spec: HashGridSpec, level_mask=None,
                                with_dx=False, accumulate=torch.float32, lattice_only=False):
    """Plain version of HG4 and HG8 (JAX ``_encode_jac_bwd``, :841): per
    level, ``index_add_`` of each corner's ``w_c ct_f + sum_d dw_cd ct_j[d]``
    (a dedup level: its lattice points' block sums,
    :func:`level_lattice_jac_bwd`, after the per-sample levels) into
    the table gradient; with ``with_dx`` the position gradient, the feature
    cotangent through dw plus the Jacobian cotangent through the mixed second
    derivatives ``d2 w_c / dx_d dx_e = s^2 sign_cd sign_ce p_c,g`` (g the
    third axis, e != d; the diagonal is zero). Returns (dtable, dx or None).
    ``accumulate``: the type the float32 updates are summed in (float64
    gives their exact sum, the card tests' reference for HG4's atomics; the
    table gradient is then returned in it). ``lattice_only``: the dedup
    levels' rows and terms alone (HG8's plain version)."""
    batch_shape = x.shape[:-1]
    xt = x.reshape(-1, 3).T.float()
    n = xt.shape[1]
    f = spec.n_features_per_level
    ctf = ct_feat.reshape(n, spec.n_levels, f).float()
    ctj = ct_jac.reshape(3, n, spec.n_levels, f).float()
    dtable = torch.zeros_like(table, dtype=accumulate)
    dx_t = torch.zeros_like(xt) if with_dx else None
    signs = _CORNER_BITS.to(x.device) * 2.0 - 1.0  # (8, 3)
    groups = spec.dedup_group_sizes
    for level in [l for l in range(spec.n_levels) if not groups[l] and not lattice_only] + [
            l for l in range(spec.n_levels) if groups[l]]:
        g_f, g_j = ctf[:, level], ctj[:, :, level]  # (N, F), (3, N, F)
        if level_mask is not None:
            m = level_mask[level].float()
            g_f, g_j = g_f * m, g_j * m
        if groups[level]:  # a dedup level: its lattice points' block sums (HG8)
            g = groups[level]
            idx, gvals, _, a = level_lattice_gather(table, xt, spec, level, g)
            li, wg, dxl = level_lattice_jac_bwd(spec, xt, level, g, idx, gvals, a, g_f, g_j)
            dtable.index_add_(0, li + spec.level_offsets[level], wg.to(accumulate))
            if with_dx:
                dx_t += dxl
            continue
        idx, w, frac = _level_taps(spec, xt, level)
        s = _scale32(spec, level)
        dw, p = _corner_partials(frac, s)  # (8, 3, N) each
        upd = w[:, :, None] * g_f[None]  # (8, N, F)
        for d in range(3):
            upd = upd + dw[:, d, :, None] * g_j[d][None]
        dtable.index_add_(0, idx.reshape(-1), upd.reshape(8 * n, f).to(accumulate))
        if with_dx:
            rows = table.T[:, idx].float()  # (F, 8, N)
            tg_f = (rows * g_f.T[:, None, :]).sum(0)  # (8, N)
            dx_t += (dw * tg_f[:, None, :]).sum(0)
            tg_j = (rows[None] * g_j.transpose(1, 2)[:, :, None, :]).sum(1)  # (3, 8, N)
            for d in range(3):
                for e in range(3):
                    if e != d:  # the third axis is 3 - d - e
                        d2 = signs[:, d, None] * signs[:, e, None] * p[:, 3 - d - e] * (s * s)
                        dx_t[d] += (d2 * tg_j[e]).sum(0)
    dx = dx_t.T.reshape(*batch_shape, 3).to(x.dtype) if with_dx else None
    return (dtable.to(table.dtype) if accumulate == torch.float32 else dtable), dx


def hashgrid_encode_with_jac(table, x, spec: HashGridSpec, level_mask=None):
    """Features (..., L*F) and their position Jacobian (3, ..., L*F),
    coordinate-major (JAX ``hashgrid_encode_with_jac``, :767): HG3 forward
    and HG4 backward on the card, the plain versions on the CPU. First order,
    as the JAX custom VJP: the table gets a cotangent from both outputs, ``x``
    one only when it requires grad, ``level_mask`` none. Nothing is saved
    for the backward but the inputs: HG4 recomputes the taps."""
    _check_spec(spec, table)
    if torch.is_grad_enabled() and (table.requires_grad or x.requires_grad):
        return _HashGridJac.apply(table, x, spec, level_mask)
    return hashgrid_jac_forward(table, x, spec, level_mask)


class _HashGridJac(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, spec, level_mask):
        ctx.save_for_backward(table, x, level_mask)
        ctx.spec = spec
        return hashgrid_jac_forward(table, x, spec, level_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_feat, ct_jac):
        table, x, level_mask = ctx.saved_tensors
        dtable, dx = hashgrid_jac_backward(table, x, ct_feat.contiguous(), ct_jac.contiguous(),
                                           ctx.spec, level_mask,
                                           with_dx=ctx.needs_input_grad[1])
        return dtable, dx, None, None


def hashgrid_jac_forward(table, x, spec: HashGridSpec, level_mask=None):
    """(feat, jac): HG3 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return hashgrid_jac_forward_launch(table, x, spec, level_mask)
    if x.device.type == "cpu":
        return hashgrid_jac_forward_plain(table, x, spec, level_mask)
    raise ValueError(f"hashgrid_jac_forward: unsupported device {x.device}")


hashgrid_jac_forward.launches = 0


def hashgrid_jac_backward(table, x, ct_feat, ct_jac, spec: HashGridSpec, level_mask=None,
                          with_dx=False):
    """(dtable, dx or None) for the cotangents of feat and jac: HG4 on CUDA
    tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return hashgrid_jac_backward_launch(table, x, ct_feat, ct_jac, spec, level_mask, with_dx)
    if x.device.type == "cpu":
        return hashgrid_jac_backward_plain(table, x, ct_feat, ct_jac, spec, level_mask, with_dx)
    raise ValueError(f"hashgrid_jac_backward: unsupported device {x.device}")


hashgrid_jac_backward.launches = 0


# HG5-HG8 alone (``hashgrid_forward`` etc. run them after HG1-HG4): the
# dedup levels' columns or rows, the other levels' zero


def hashgrid_lattice_forward(table, x, spec: HashGridSpec, level_mask=None):
    """The dedup levels' columns of the features (..., L*F), the others zero:
    HG5 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        lf = spec.n_output_dims
        return hashgrid_lattice_forward_launch(table, x, spec, level_mask).reshape(
            *x.shape[:-1], lf)
    if x.device.type == "cpu":
        return hashgrid_forward_plain(table, x, spec, level_mask, lattice_only=True)
    raise ValueError(f"hashgrid_lattice_forward: unsupported device {x.device}")


def hashgrid_lattice_backward(table, x, dout, spec: HashGridSpec, level_mask=None,
                              with_dx=False):
    """The dedup levels' rows of the table gradient and their d x terms: HG6
    on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return hashgrid_lattice_backward_launch(table, x, dout, spec, level_mask, with_dx)
    if x.device.type == "cpu":
        return hashgrid_backward_plain(table, x, dout, spec, level_mask, with_dx,
                                       lattice_only=True)
    raise ValueError(f"hashgrid_lattice_backward: unsupported device {x.device}")


def hashgrid_lattice_jac_forward(table, x, spec: HashGridSpec, level_mask=None):
    """The dedup levels' columns of (feat, jac): HG7 on CUDA tensors, the
    plain version on CPU tensors."""
    if x.device.type == "cuda":
        lf = spec.n_output_dims
        feat, jac = hashgrid_lattice_jac_forward_launch(table, x, spec, level_mask)
        return feat.reshape(*x.shape[:-1], lf), jac.reshape(3, *x.shape[:-1], lf)
    if x.device.type == "cpu":
        return hashgrid_jac_forward_plain(table, x, spec, level_mask, lattice_only=True)
    raise ValueError(f"hashgrid_lattice_jac_forward: unsupported device {x.device}")


def hashgrid_lattice_jac_backward(table, x, ct_feat, ct_jac, spec: HashGridSpec,
                                  level_mask=None, with_dx=False):
    """The dedup levels' rows of the jac path's table gradient and their d x
    terms: HG8 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return hashgrid_lattice_jac_backward_launch(table, x, ct_feat, ct_jac, spec, level_mask,
                                                    with_dx)
    if x.device.type == "cpu":
        return hashgrid_jac_backward_plain(table, x, ct_feat, ct_jac, spec, level_mask, with_dx,
                                           lattice_only=True)
    raise ValueError(f"hashgrid_lattice_jac_backward: unsupported device {x.device}")


for _counter in (hashgrid_lattice_forward, hashgrid_lattice_backward,
                 hashgrid_lattice_jac_forward, hashgrid_lattice_jac_backward):
    _counter.launches = 0


# ---------------------------------------------------------------------------
# the kernels (HG1-HG4)
# ---------------------------------------------------------------------------


class _Level(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float), ("res", ctypes.c_uint32),
                ("size", ctypes.c_uint32), ("offset", ctypes.c_uint32),
                ("hashed", ctypes.c_int), ("g", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def level_params(spec: HashGridSpec):
    """The kernels' per-level constants: scale (float32), resolution, size,
    offset, whether the level is hashed and its dedup block size g (0:
    per-sample taps, HG1-HG4; else HG5-HG8) (built once per spec: the
    properties recompute every level's layout on each access)."""
    arr = (_Level * MAX_LEVELS)()
    scales, res, sizes = spec.scales, spec.resolutions, spec.level_sizes
    offsets, hashed, groups = spec.level_offsets, spec.level_hashed, spec.dedup_group_sizes
    for l in range(spec.n_levels):
        arr[l] = _Level(scales[l], res[l], sizes[l], offsets[l], int(hashed[l]), groups[l])
    return arr


def _split(spec: HashGridSpec):
    """(dedup levels, per-sample levels) of ``spec``: the dedup levels are
    its first ones."""
    n_lat = sum(1 for g in spec.dedup_group_sizes if g)
    return n_lat, spec.n_levels - n_lat


def _check_blocks(name, spec: HashGridSpec, n: int):
    for level, g in enumerate(spec.dedup_group_sizes):
        if g and n % g:
            raise ValueError(f"{name}: {n} samples do not divide level {level}'s dedup "
                             f"block of {g}")


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
    """Launch ``csrc/hashgrid_fwd.cu`` (HG1) for CUDA x on the per-sample
    levels, then HG5 (:func:`hashgrid_lattice_forward_launch`) on the dedup
    levels, if the spec has any."""
    xf, mask = _operands("hashgrid_forward", table, x, spec, level_mask)
    n = xf.shape[0]
    f = spec.n_features_per_level
    n_lat, n_ps = _split(spec)
    out = torch.empty((n, spec.n_levels * f), dtype=torch.float32, device=x.device)
    if n_ps:
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
    if n_lat:
        hashgrid_lattice_forward_launch(table, xf, spec, mask, out)
    return out.reshape(*x.shape[:-1], spec.n_levels * f)


_LATTICE_SUPPORTED = ("n_features_per_level in {1, 2, 4, 8}, dedup blocks dividing the sample "
                      "count, of at most 8 samples (16 at F <= 2)")


def hashgrid_lattice_forward_launch(table, x, spec: HashGridSpec, level_mask=None, out=None):
    """Launch ``csrc/hashgrid_lattice_fwd.cu`` (HG5): the dedup levels'
    columns of the (N, L*F) features ``out`` (allocated, its other columns
    zero, when None; HG1 fills them in :func:`hashgrid_forward_launch`).
    Returns ``out``; with no samples it launches nothing."""
    xf, mask = _operands("hashgrid_lattice_forward", table, x, spec, level_mask)
    n = xf.shape[0]
    f, lf = spec.n_features_per_level, spec.n_output_dims
    _check_blocks("hashgrid_lattice_forward", spec, n)
    if out is None:
        out = torch.zeros((n, lf), dtype=torch.float32, device=x.device)
    cuda_build.check_operands("hashgrid_lattice_forward", (out,), ((n, lf),), x.device)
    if n == 0:
        return out
    fn = cuda_build.entry("hashgrid_lattice_fwd", "hashgrid_lattice_fwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Level), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(xf.data_ptr(), n, table.data_ptr(), spec.n_levels, f, level_params(spec),
                mask.data_ptr() if mask is not None else None, out.data_ptr(), stream)
    cuda_build.check(rc, "hashgrid_lattice_forward", _LATTICE_SUPPORTED)
    hashgrid_lattice_forward.launches += 1
    return out


def dense_rows(spec: HashGridSpec) -> int:
    """The table rows up to the end of the last dense level: HG2 sums them
    in float64 (their rows take thousands of updates, where a float32
    running sum in the atomics' order strays past the tests' 1e-5), the
    hashed levels' rows in float32."""
    ends = [o + n for o, n, h in zip(spec.level_offsets, spec.level_sizes, spec.level_hashed)
            if not h]
    return max(ends, default=0)


def lattice_dense_rows(spec: HashGridSpec) -> int:
    """The table rows up to the end of the last level that is both a dedup
    level and dense: HG6 / HG8 sum them in float64, as HG2 its dense rows."""
    ends = [o + n for o, n, h, g in zip(spec.level_offsets, spec.level_sizes, spec.level_hashed,
                                        spec.dedup_group_sizes) if g and not h]
    return max(ends, default=0)


def hashgrid_backward_launch(table, x, dout, spec: HashGridSpec, level_mask=None,
                             with_dx=False):
    """Launch ``csrc/hashgrid_bwd.cu`` (HG2) for CUDA tensors; see
    :func:`hashgrid_backward` for the outputs. The kernel scatters into the
    zeroed (T, F) gradient, the dense levels' rows through a zeroed float64
    scratch (:func:`dense_rows`). With no samples it returns zeros and
    launches nothing."""
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
    n_lat, n_ps = _split(spec)
    if n_ps:
        fn = cuda_build.entry("hashgrid_bwd", "hashgrid_bwd", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(_Level), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ])
        # a float64 scratch only where a per-sample level is dense
        groups, hashed = spec.dedup_group_sizes, spec.level_hashed
        rows = dense_rows(spec) if any(not g and not h for g, h in zip(groups, hashed)) else 0
        wide = torch.zeros((rows, f), dtype=torch.float64, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(xf.data_ptr(), n, ct.data_ptr(), table.data_ptr(), spec.n_levels, f,
                    level_params(spec), mask.data_ptr() if mask is not None else None,
                    dtable.data_ptr(), wide.data_ptr(), rows,
                    dx.data_ptr() if with_dx else None, stream)
        cuda_build.check(rc, "hashgrid_backward", "n_features_per_level in {1, 2, 4, 8}")
        hashgrid_backward.launches += 1
    if n_lat:  # after HG2: it adds its rows and its d x terms to HG2's
        _lattice_backward(table, xf, (ct,), spec, mask, dtable, dx, accumulate_dx=bool(n_ps))
    return dtable, (dx.reshape(*x.shape[:-1], 3) if with_dx else None)


def hashgrid_lattice_backward_launch(table, x, dout, spec: HashGridSpec, level_mask=None,
                                     with_dx=False):
    """Launch ``csrc/hashgrid_lattice_bwd.cu`` (HG6) alone: the dedup levels'
    rows of the table gradient (T, F) (the other rows zero) and, with
    ``with_dx``, their terms of the position gradient (..., 3) (else None).
    :func:`hashgrid_backward_launch` runs it after HG2."""
    xf, mask = _operands("hashgrid_lattice_backward", table, x, spec, level_mask)
    n, lf = xf.shape[0], spec.n_output_dims
    ct = dout.reshape(n, lf).contiguous()
    cuda_build.check_operands("hashgrid_lattice_backward", (ct,), ((n, lf),), x.device)
    dtable = torch.zeros_like(table)
    dx = torch.empty((n, 3), dtype=torch.float32, device=x.device) if with_dx else None
    if n:
        _lattice_backward(table, xf, (ct,), spec, mask, dtable, dx, accumulate_dx=False)
    return dtable, (dx.reshape(*x.shape[:-1], 3) if with_dx else None)


def _lattice_backward(table, xf, cts, spec, mask, dtable, dx, accumulate_dx):
    """HG6 (one cotangent) or HG8 (the features' and the Jacobian's) on
    flattened x (n, 3): adds the dedup levels' rows into ``dtable`` (their
    dense rows through a zeroed float64 scratch) and, when ``dx`` is given,
    their d x terms to it (``accumulate_dx``) or into it."""
    n = xf.shape[0]
    f = spec.n_features_per_level
    _check_blocks("hashgrid_lattice_backward", spec, n)
    jac = len(cts) == 2
    if cts[0].dtype != torch.float32 or cts[-1].dtype != torch.float32:
        raise ValueError("hashgrid_lattice_backward: cotangents must be float32")
    n_lat, _ = _split(spec)
    rows = lattice_dense_rows(spec)
    wide = torch.zeros((rows, f), dtype=torch.float64, device=xf.device)
    part = (torch.empty((n_lat, n, 3), dtype=torch.float32, device=xf.device)
            if dx is not None else None)
    head = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * len(cts)
    fn = cuda_build.entry(
        "hashgrid_lattice_bwd", "hashgrid_lattice_jac_bwd" if jac else "hashgrid_lattice_bwd",
        head + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_Level),
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = fn(xf.data_ptr(), n, *(c.data_ptr() for c in cts), table.data_ptr(),
                spec.n_levels, f, level_params(spec),
                mask.data_ptr() if mask is not None else None, dtable.data_ptr(),
                wide.data_ptr(), rows, dx.data_ptr() if dx is not None else None,
                part.data_ptr() if part is not None else None, int(accumulate_dx), stream)
    name = "hashgrid_lattice_jac_backward" if jac else "hashgrid_lattice_backward"
    cuda_build.check(rc, name, _LATTICE_SUPPORTED)
    (hashgrid_lattice_jac_backward if jac else hashgrid_lattice_backward).launches += 1


def hashgrid_jac_forward_launch(table, x, spec: HashGridSpec, level_mask=None):
    """Launch ``csrc/hashgrid_jac_fwd.cu`` (HG3) for CUDA x; see
    :func:`hashgrid_jac_forward_plain` for the outputs. With no samples it
    returns empty outputs and launches nothing."""
    xf, mask = _operands("hashgrid_jac_forward", table, x, spec, level_mask)
    n = xf.shape[0]
    f, lf = spec.n_features_per_level, spec.n_output_dims
    feat = torch.empty((n, lf), dtype=torch.float32, device=x.device)
    jac = torch.empty((3, n, lf), dtype=torch.float32, device=x.device)
    n_lat, n_ps = _split(spec)
    if n > 0 and n_ps:
        fn = cuda_build.entry("hashgrid_jac_fwd", "hashgrid_jac_fwd", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_Level), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(xf.data_ptr(), n, table.data_ptr(), spec.n_levels, f, level_params(spec),
                    mask.data_ptr() if mask is not None else None, feat.data_ptr(),
                    jac.data_ptr(), stream)
        cuda_build.check(rc, "hashgrid_jac_forward", "n_features_per_level in {1, 2, 4, 8}")
        hashgrid_jac_forward.launches += 1
    if n > 0 and n_lat:
        hashgrid_lattice_jac_forward_launch(table, xf, spec, mask, (feat, jac))
    return feat.reshape(*x.shape[:-1], lf), jac.reshape(3, *x.shape[:-1], lf)


def hashgrid_lattice_jac_forward_launch(table, x, spec: HashGridSpec, level_mask=None,
                                        out=None):
    """Launch ``csrc/hashgrid_lattice_fwd.cu``'s HG7: the dedup levels'
    columns of the features (N, L*F) and of their Jacobian (3, N, L*F) in
    ``out`` = (feat, jac) (allocated, the other columns zero, when None; HG3
    fills them in :func:`hashgrid_jac_forward_launch`). Returns (feat, jac);
    with no samples it launches nothing."""
    xf, mask = _operands("hashgrid_lattice_jac_forward", table, x, spec, level_mask)
    n = xf.shape[0]
    f, lf = spec.n_features_per_level, spec.n_output_dims
    _check_blocks("hashgrid_lattice_jac_forward", spec, n)
    if out is None:
        out = (torch.zeros((n, lf), dtype=torch.float32, device=x.device),
               torch.zeros((3, n, lf), dtype=torch.float32, device=x.device))
    feat, jac = out
    cuda_build.check_operands("hashgrid_lattice_jac_forward", (feat, jac),
                              ((n, lf), (3, n, lf)), x.device)
    if n == 0:
        return feat, jac
    fn = cuda_build.entry("hashgrid_lattice_fwd", "hashgrid_lattice_jac_fwd", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Level), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(xf.data_ptr(), n, table.data_ptr(), spec.n_levels, f, level_params(spec),
                mask.data_ptr() if mask is not None else None, feat.data_ptr(), jac.data_ptr(),
                stream)
    cuda_build.check(rc, "hashgrid_lattice_jac_forward", _LATTICE_SUPPORTED)
    hashgrid_lattice_jac_forward.launches += 1
    return feat, jac


def hashgrid_jac_backward_launch(table, x, ct_feat, ct_jac, spec: HashGridSpec,
                                 level_mask=None, with_dx=False):
    """Launch ``csrc/hashgrid_jac_bwd.cu`` (HG4) for CUDA tensors; see
    :func:`hashgrid_jac_backward` for the outputs. The kernel scatters into
    the zeroed (T, F) gradient. With no samples it returns zeros and launches
    nothing."""
    xf, mask = _operands("hashgrid_jac_backward", table, x, spec, level_mask)
    n = xf.shape[0]
    f, lf = spec.n_features_per_level, spec.n_output_dims
    if ct_feat.dtype != torch.float32 or ct_jac.dtype != torch.float32:
        raise ValueError(f"hashgrid_jac_backward: cotangents must be float32, got "
                         f"{ct_feat.dtype} {ct_jac.dtype}")
    ctf = ct_feat.reshape(n, lf).contiguous()
    ctj = ct_jac.reshape(3, n, lf).contiguous()
    cuda_build.check_operands("hashgrid_jac_backward", (ctf, ctj), ((n, lf), (3, n, lf)),
                              x.device)
    dx = torch.empty((n, 3), dtype=torch.float32, device=x.device) if with_dx else None
    dtable = torch.zeros_like(table)
    n_lat, n_ps = _split(spec)
    if n > 0 and n_ps:
        fn = cuda_build.entry("hashgrid_jac_bwd", "hashgrid_jac_bwd", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_Level),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ])
        # with d x: each level's term, summed by the kernel's second pass in level order
        part = (torch.empty((spec.n_levels, n, 3), dtype=torch.float32, device=x.device)
                if with_dx else None)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(xf.data_ptr(), n, ctf.data_ptr(), ctj.data_ptr(), table.data_ptr(),
                    spec.n_levels, f, level_params(spec),
                    mask.data_ptr() if mask is not None else None, dtable.data_ptr(),
                    dx.data_ptr() if with_dx else None, part.data_ptr() if with_dx else None,
                    stream)
        cuda_build.check(rc, "hashgrid_jac_backward", "n_features_per_level in {1, 2, 4, 8}")
        hashgrid_jac_backward.launches += 1
    if n > 0 and n_lat:  # HG8 after HG4: it adds its rows and d x terms
        _lattice_backward(table, xf, (ctf, ctj), spec, mask, dtable, dx,
                          accumulate_dx=bool(n_ps))
    return dtable, (dx.reshape(*x.shape[:-1], 3) if with_dx else None)


def hashgrid_lattice_jac_backward_launch(table, x, ct_feat, ct_jac, spec: HashGridSpec,
                                         level_mask=None, with_dx=False):
    """Launch ``csrc/hashgrid_lattice_bwd.cu``'s HG8 alone: the dedup levels'
    rows of the table gradient and, with ``with_dx``, their d x terms
    (:func:`hashgrid_lattice_backward_launch` for the encoding with its
    Jacobian; :func:`hashgrid_jac_backward_launch` runs it after HG4)."""
    xf, mask = _operands("hashgrid_lattice_jac_backward", table, x, spec, level_mask)
    n, lf = xf.shape[0], spec.n_output_dims
    ctf = ct_feat.reshape(n, lf).contiguous()
    ctj = ct_jac.reshape(3, n, lf).contiguous()
    cuda_build.check_operands("hashgrid_lattice_jac_backward", (ctf, ctj),
                              ((n, lf), (3, n, lf)), x.device)
    dtable = torch.zeros_like(table)
    dx = torch.empty((n, 3), dtype=torch.float32, device=x.device) if with_dx else None
    if n:
        _lattice_backward(table, xf, (ctf, ctj), spec, mask, dtable, dx, accumulate_dx=False)
    return dtable, (dx.reshape(*x.shape[:-1], 3) if with_dx else None)
