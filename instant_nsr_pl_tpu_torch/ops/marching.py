"""Occupancy grid + static-capacity ray marching (the nerfacc role).

Port of ``instant_nsr_pl_tpu/ops/marching.py`` (grid state and update
:40-424, lookups :427-475, the sample schedule :501-519, march and packing
:482-884). It keeps the ``PackedSamples`` contract and the float expressions
of the JAX package, so on the AABB grid with uniform steps both give the same
packed buffers bit for bit, and drops the TPU layout tricks (bit-bricks,
lane-native probes, the two-level selection sort): on the TPU they compute
the same outputs as the plain dilated-field probe and single sort this port
uses.

Unbounded scenes march a grid in contracted space (``UN_BOUNDED_SPHERE``:
cells are looked up through ``contract_coords`` and updated at points placed
by ``uncontract_from_unisphere``) with cone-angle stepping, one probe per
sample (as in the JAX package, the strided probe and the group compaction
need an AABB grid and uniform steps). The cone-angle schedule's geometric
part is ``base * (1 + c) ** k`` with the power correctly rounded to float32
(evaluated in float64); XLA's float32 ``pow`` is not correctly rounded, so
there the two packages' distances differ by an ulp in about one sample of a
hundred and the packed buffers are equal only where no sample sits on a
cell or range boundary.

Random draws (the march's stratified jitter, the grid update's cell choice
and jitter) come from a ``torch.Generator``; they cannot repeat the JAX
package's bits, so both functions also take the draws themselves, which is
how the tests feed the two packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.device import resolve_device
from instant_nsr_pl_tpu_torch.ops.activations import fma32
from instant_nsr_pl_tpu_torch.ops.contraction import (
    ContractionType,
    contract_coords,
    uncontract_from_unisphere,
)


@dataclasses.dataclass(frozen=True)
class OccGridSpec:
    """Static occupancy-grid description (hashable)."""

    resolution: int = 128
    radius: float = 1.5
    contraction_type: ContractionType = ContractionType.AABB

    @property
    def num_cells(self) -> int:
        return self.resolution**3


class OccupancyGridState(NamedTuple):
    """EMA occupancy values + binarized field, flattened x-fastest
    (``i = x + y*R + z*R^2``). ``binary_dilated`` is the 3^3 max-pool of
    ``binary``: the conservative superset the strided march probes."""

    occs: torch.Tensor  # (R^3,) float32
    binary: torch.Tensor  # (R^3,) bool
    binary_dilated: torch.Tensor  # (R^3,) bool


def occupancy_grid_init(spec: OccGridSpec, device=None) -> OccupancyGridState:
    dev = resolve_device(device)
    n = spec.num_cells
    return OccupancyGridState(
        occs=torch.zeros(n, dtype=torch.float32, device=dev),
        binary=torch.zeros(n, dtype=torch.bool, device=dev),
        binary_dilated=torch.zeros(n, dtype=torch.bool, device=dev),
    )


def _dilate_binary(binary, resolution):
    """3^3 max-pool of the flattened binary field (zero padding)."""
    b = binary.reshape(1, 1, resolution, resolution, resolution).float()
    d = torch.nn.functional.max_pool3d(b, 3, stride=1, padding=1)
    return (d > 0).reshape(-1)


def _postprocess_binary(binary, spec: OccGridSpec):
    """binary -> binary_dilated (the JAX twin also packs bit-bricks, which
    only its TPU probe reads)."""
    return _dilate_binary(binary, spec.resolution)


def _cell_coords(indices, resolution):
    ix = indices % resolution
    iy = (indices // resolution) % resolution
    iz = indices // (resolution * resolution)
    return torch.stack([ix, iy, iz], dim=-1)


def occupancy_update_draws(state: OccupancyGridState, spec: OccGridSpec, generator,
                           warmup=False, slab=False, sample_divisor=8):
    """The random numbers of one :func:`occupancy_grid_update`, drawn from
    ``generator`` on the grid's device: ``jitter`` (M, 3) uniform in [0, 1)
    for the M evaluated cells and, in the random mode, ``uniform`` (m,) cell
    indices and ``occupied`` (m,) ranks in [0, max(total, 1)) among the
    occupied cells (total = number of occupied cells)."""
    dev = state.occs.device
    n = spec.num_cells
    m = n // sample_divisor
    if warmup:
        return {"jitter": torch.rand((n, 3), generator=generator, device=dev)}
    if slab:
        return {"jitter": torch.rand((m, 3), generator=generator, device=dev)}
    total = state.binary.sum().clamp(min=1)
    rank = torch.rand(m, generator=generator, device=dev, dtype=torch.float64) * total
    return {
        "uniform": torch.randint(0, n, (m,), generator=generator, device=dev),
        "occupied": torch.minimum(rank.long(), total - 1),
        "jitter": torch.rand((2 * m, 3), generator=generator, device=dev),
    }


def occupancy_grid_update(
    state: OccupancyGridState,
    spec: OccGridSpec,
    occ_eval_fn,
    generator=None,
    *,
    draws=None,
    occ_thre: float = 0.01,
    ema_decay: float = 0.95,
    warmup: bool = False,
    sample_divisor: int = 8,
    phase=None,
    group=None,
) -> OccupancyGridState:
    """One nerfacc-style grid update (JAX ``occupancy_grid_update``).

    Cells: every cell in ``warmup``; else, with ``phase`` (the update ordinal
    mod ``sample_divisor``), the contiguous slab ``[phase * m, (phase + 1) *
    m)`` of ``m = num_cells // sample_divisor`` cells, which touches every
    cell once per ``sample_divisor`` updates; else (``phase=None``, the
    random mode) ``m`` uniform cells plus ``m`` occupied cells by inverse CDF
    over the binary field (the uniform half again when nothing is occupied).
    Each chosen cell is evaluated at a jittered point, ``occ_eval_fn`` maps
    world points (M, 3) to occupancy values (M,), and the EMA is
    ``max(occs * ema_decay, occ)``; the threshold is ``min(mean(occs),
    occ_thre)`` and the binary field is dilated by a 3^3 max-pool. A cell
    drawn twice in the random mode keeps its last draw's value.

    ``draws`` (see :func:`occupancy_update_draws`) replaces the draws from
    ``generator``. With ``group`` (a data-parallel run's
    ``parallel.distributed.Group``, the JAX ``mesh``) the evaluations are
    split in contiguous shards over the ranks and gathered back, so every
    rank applies the identical update from its replicated generator's
    draws."""
    res = spec.resolution
    n = spec.num_cells
    dev = state.occs.device
    slab = not warmup and phase is not None
    m = n // sample_divisor
    if draws is None:
        draws = occupancy_update_draws(state, spec, generator, warmup=warmup, slab=slab,
                                       sample_divisor=sample_divisor)
    if warmup:
        indices = torch.arange(n, device=dev)
    elif slab:
        start = (int(phase) % sample_divisor) * m
        indices = torch.arange(m, device=dev) + start
    else:
        uniform = draws["uniform"].to(dev).long()
        cdf = torch.cumsum(state.binary.long(), dim=0)
        total = cdf[-1]
        occupied = torch.searchsorted(cdf, draws["occupied"].to(dev).long(), right=True)
        occupied = torch.where(total > 0, torch.clamp(occupied, 0, n - 1), uniform)
        indices = torch.cat([uniform, occupied])
    coords = _cell_coords(indices, res).float()
    unit = (coords + draws["jitter"].to(dev)) / res  # the contracted [0,1]^3 cube
    world = uncontract_from_unisphere(unit, spec.radius, spec.contraction_type)
    with torch.no_grad():
        if group is not None:
            occ = group.sharded_eval(lambda w: occ_eval_fn(w).reshape(-1).float(), world)
        else:
            occ = occ_eval_fn(world).reshape(-1).float()
    if warmup:
        occs = torch.maximum(state.occs * ema_decay, occ)
    elif slab:
        occs = state.occs.clone()
        occs[start:start + m] = torch.maximum(state.occs[start:start + m] * ema_decay, occ)
    else:
        new_vals = torch.maximum(state.occs[indices] * ema_decay, occ)
        # a cell drawn twice keeps its last value: unique indices make the
        # write deterministic on the card as on the CPU
        order = torch.argsort(indices, stable=True)
        sorted_idx = indices[order]
        last = torch.ones_like(sorted_idx, dtype=torch.bool)
        last[:-1] = sorted_idx[1:] != sorted_idx[:-1]
        occs = state.occs.clone()
        occs[sorted_idx[last]] = new_vals[order[last]]
    thre = torch.clamp(occs.mean(), max=occ_thre)
    binary = occs > thre
    return OccupancyGridState(
        occs=occs, binary=binary, binary_dilated=_postprocess_binary(binary, spec)
    )


def occupancy_lookup_coords(binary, px, py, pz, spec: OccGridSpec, clamp=False):
    """Coordinate-wise occupancy query at world points (through
    ``contract_coords``). ``clamp=True`` clamps out-of-domain probes onto the
    boundary cell instead of returning False (the strided group probe, whose
    group centres may sit just outside the domain)."""
    ux, uy, uz = contract_coords(px, py, pz, spec.radius, spec.contraction_type)
    res = spec.resolution
    # clamp in float before the integer cast: identical cells for in-range
    # values, and a saturating cast for the far-away probes of missed rays
    cx, cy, cz = (
        torch.clamp(torch.floor(u * res), 0, res - 1).long() for u in (ux, uy, uz)
    )
    hit = binary[cx + cy * res + cz * (res * res)]
    if clamp:
        return hit
    inside = (
        (ux >= 0.0) & (ux < 1.0)
        & (uy >= 0.0) & (uy < 1.0)
        & (uz >= 0.0) & (uz < 1.0)
    )
    return hit & inside


class PackedSamples(NamedTuple):
    """Fixed-capacity packed samples, sorted by ray (padding at the tail);
    the static-shape analog of nerfacc's ragged packing."""

    ray_indices: torch.Tensor  # (CAP,) int64, ascending; padding = n_rays - 1
    t_starts: torch.Tensor  # (CAP,) float32
    t_ends: torch.Tensor  # (CAP,) float32
    valid: torch.Tensor  # (CAP,) bool
    num_valid: torch.Tensor  # () int64: live samples before truncation
    ray_kept: torch.Tensor  # (R,) bool: all of the ray's live samples fit
    ray_ends: torch.Tensor  # (R,) int64: exclusive slot offset of ray r's end


def _first_true(mask, count, fill):
    """Ascending flat indices of the first ``count`` True entries, padded
    with ``fill`` (the single key sort of the JAX twin)."""
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)[:count]
    sel = torch.full((count,), fill, dtype=torch.long, device=mask.device)
    sel[: idx.shape[0]] = idx
    return sel


def t_schedule(t_min, render_step_size, cone_angle, max_samples):
    """Per-ray sample boundaries t_0..t_S, (R, S+1) float32 (JAX
    ``_t_schedule``). ``cone_angle == 0``: uniform steps ``t_i = t_min + i *
    s``. ``cone_angle = c > 0``: nerfacc's exponential stepping, the
    recurrence ``t_{k+1} = t_k + max(t_k * c, s)`` in closed form: linear up
    to ``t >= s / c`` (``n_lin`` steps), geometric with ratio ``1 + c`` after
    it. The affine parts round as fused multiply-adds; the power ``(1 +
    c) ** k`` is correctly rounded to float32."""
    s = render_step_size
    i = torch.arange(max_samples + 1, dtype=torch.float32, device=t_min.device)[None, :]
    t0 = t_min[:, None]
    if cone_angle <= 0.0:
        return fma32(i, s, t0)
    c = cone_angle
    switch = float(np.float32(s / c))
    # a true division: CUDA multiplies by the reciprocal of a host scalar
    step = t0.new_tensor(float(np.float32(s)))
    n_lin = torch.ceil(torch.clamp(switch - t0, min=0.0) / step)  # (R, 1)
    t_lin = fma32(torch.minimum(i, n_lin), s, t0)
    ratio = torch.tensor(float(np.float32(1.0 + c)), dtype=torch.float64, device=t_min.device)
    growth = torch.pow(ratio, torch.clamp(i - n_lin, min=0.0).double()).float()
    t_geo = fma32(n_lin, s, t0) * growth
    return torch.where(i <= n_lin, t_lin, t_geo)


def _expand_groups(sel, num_valid, ray_kept, ray_ends, R, sg, k, t_min, t_max, step):
    """Expand sorted group ids (padding = R*sg) into packed per-sample
    buffers, with distances from the uniform schedule
    ``t_start[ray, s] = t_min[ray] + s * step``."""
    g_ray = torch.clamp(sel, max=R * sg - 1) // sg
    cap = sel.shape[0] * k
    off = (torch.arange(cap, device=sel.device) % k).float()
    sel_f = sel.repeat_interleave(k)
    gpf = sel_f < R * sg
    safe_f = torch.clamp(sel_f, max=R * sg - 1)
    rayf = safe_f // sg
    s_idx = (safe_f % sg).float() * k + off
    ts = fma32(s_idx, step, t_min[g_ray].repeat_interleave(k))
    te = ts + step
    in_range = 0.5 * (ts + te) < t_max[g_ray].repeat_interleave(k)
    zero = torch.zeros_like(ts)
    # out-of-range slots of a packed block keep their schedule t (only fully
    # dead padding blocks zero out), so every aligned k-block is a uniform
    # run of one ray; those slots stay valid=False and are never composited
    return PackedSamples(
        ray_indices=torch.where(gpf, rayf, torch.full_like(rayf, R - 1)),
        t_starts=torch.where(gpf, ts, zero),
        t_ends=torch.where(gpf, te, zero),
        valid=gpf & in_range,
        num_valid=num_valid,
        ray_kept=ray_kept,
        ray_ends=ray_ends,
    )


def _march_groups(rays_o, rays_d, t_min, t_max, *, render_step_size,
                  max_samples, capacity, occ_spec, occ_dilated, occ_stride):
    """Group-compacted strided march (JAX ``_march_groups_lanes``): one
    dilated-field probe per group of k samples, compaction at group
    granularity, every float expression as in the JAX twin."""
    R = rays_o.shape[0]
    S = max_samples
    k = occ_stride
    step = render_step_size
    if S % k or capacity % k:
        raise ValueError(f"group march needs k | S and k | capacity: {S}, {capacity}, {k}")
    sg = S // k
    ig = torch.arange(sg, dtype=torch.float32, device=rays_o.device)[None, :]
    t0 = t_min[:, None]

    def t_at(i):  # schedule distance t0 + i * step of float sample index i
        return fma32(i, step, t0)

    t_c = 0.5 * (t_at(ig * k) + t_at((ig + 1.0) * k))
    pts = [fma32(rays_d[:, a:a + 1], t_c, rays_o[:, a:a + 1]) for a in range(3)]
    occ_g = occupancy_lookup_coords(occ_dilated, *pts, occ_spec, clamp=True)

    t_mid_g0 = 0.5 * (t_at(ig * k) + t_at(ig * k + 1.0))
    gvalid = occ_g & (t_mid_g0 < t_max[:, None])

    tm = t_max[:, None]
    num_valid = torch.zeros((), dtype=torch.long, device=rays_o.device)
    for j in range(k):
        t_mid_j = 0.5 * (t_at(ig * k + float(j)) + t_at(ig * k + float(j + 1)))
        num_valid = num_valid + (occ_g & (t_mid_j < tm)).sum()

    sel = _first_true(gvalid, capacity // k, R * sg)
    cum_g = torch.cumsum(gvalid.sum(dim=1), dim=0)
    ray_kept = cum_g * k <= capacity
    ray_ends = torch.clamp(cum_g, max=capacity // k) * k
    return _expand_groups(
        sel, num_valid, ray_kept, ray_ends, R, sg, k, t_min, t_max, step
    )


def march_rays(
    rays_o,
    rays_d,
    t_min,
    t_max,
    *,
    render_step_size: float,
    max_samples: int,
    capacity: int,
    occ_binary=None,
    occ_spec: OccGridSpec | None = None,
    occ_dilated=None,
    occ_stride: int = 1,
    group_compact: bool = False,
    jitter=None,
    cone_angle: float = 0.0,
) -> PackedSamples:
    """March rays, prune with the occupancy grid, compact to ``capacity``
    (JAX ``march_rays``; see its docstring for the strided probe and the
    group compaction). ``jitter``: (R,) uniform [0, 1) draws of the
    stratified march, which moves each ray's start by ``jitter *
    render_step_size`` (nerfacc's stratified sampling). ``cone_angle > 0``
    steps exponentially (:func:`t_schedule`; unbounded scenes) and probes the
    grid once per sample."""
    R = rays_o.shape[0]
    S = max_samples
    t_min = t_min.float()
    t_max = t_max.float()
    if jitter is not None:
        t_min = t_min + jitter.float() * render_step_size
    strided = occ_binary is not None and occ_stride > 1 and occ_dilated is not None
    if (strided or group_compact) and (cone_angle > 0.0
                                       or occ_spec.contraction_type != ContractionType.AABB):
        raise ValueError("the strided probe and the group compaction need an AABB grid and "
                         "uniform steps (cone_angle 0)")
    if group_compact:
        if not strided:
            raise ValueError(
                "group_compact requires the strided occupancy path "
                "(occ_stride > 1, occ_dilated given)"
            )
        return _march_groups(
            rays_o, rays_d, t_min, t_max, render_step_size=render_step_size,
            max_samples=S, capacity=capacity, occ_spec=occ_spec,
            occ_dilated=occ_dilated, occ_stride=occ_stride,
        )

    t_bounds = t_schedule(t_min, render_step_size, cone_angle, S)  # (R, S+1)
    t_starts = t_bounds[:, :-1]
    t_ends = t_bounds[:, 1:]
    t_mid = 0.5 * (t_starts + t_ends)

    valid = t_mid < t_max[:, None]
    if occ_binary is not None:
        if strided:
            k = occ_stride
            if S % k:
                raise ValueError(f"occ_stride {k} must divide max_samples {S}")
            t_c = 0.5 * (t_bounds[:, :S:k] + t_bounds[:, k::k])
            pts = [fma32(rays_d[:, a:a + 1], t_c, rays_o[:, a:a + 1]) for a in range(3)]
            occ_g = occupancy_lookup_coords(occ_dilated, *pts, occ_spec, clamp=True)
            occ = occ_g.repeat_interleave(k, dim=1)
        else:
            pts = [fma32(rays_d[:, a:a + 1], t_mid, rays_o[:, a:a + 1]) for a in range(3)]
            occ = occupancy_lookup_coords(occ_binary, *pts, occ_spec)
        valid = valid & occ

    flat_valid = valid.reshape(-1)
    sel = _first_true(flat_valid, capacity, R * S)
    packed_valid = sel < R * S
    safe = torch.clamp(sel, max=R * S - 1)
    ray_indices = torch.where(packed_valid, safe // S, torch.full_like(safe, R - 1))
    cum = torch.cumsum(valid.sum(dim=1), dim=0)
    zero = torch.zeros(capacity, dtype=torch.float32, device=rays_o.device)
    return PackedSamples(
        ray_indices=ray_indices,
        t_starts=torch.where(packed_valid, t_starts.reshape(-1)[safe], zero),
        t_ends=torch.where(packed_valid, t_ends.reshape(-1)[safe], zero),
        valid=packed_valid,
        num_valid=flat_valid.sum(),
        ray_kept=cum <= capacity,
        ray_ends=torch.clamp(cum, max=capacity),
    )


def packed_positions(samples: PackedSamples, rays_o, rays_d, group: int = 1):
    """World positions / directions / midpoints / intervals of packed
    samples. ``group=k > 1`` relies on the group-compacted layout (every
    aligned k-block belongs to one ray) and reads each ray once per block."""
    t_mid = 0.5 * (samples.t_starts + samples.t_ends)
    if group > 1:
        cap = samples.ray_indices.shape[0]
        if cap % group:
            raise ValueError(f"capacity {cap} is not a multiple of group {group}")
        g = cap // group
        gray = samples.ray_indices.reshape(g, group)[:, 0]
        o = rays_o[gray][:, None, :].expand(g, group, 3).reshape(cap, 3)
        d = rays_d[gray][:, None, :].expand(g, group, 3).reshape(cap, 3)
    else:
        o = rays_o[samples.ray_indices]
        d = rays_d[samples.ray_indices]
    positions = o + d * t_mid[:, None]
    intervals = samples.t_ends - samples.t_starts
    return positions, d, t_mid, intervals
