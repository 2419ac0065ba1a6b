"""Isosurface extraction via marching tetrahedra, on the card or the host.

:func:`marching_tetrahedra` marches where the level grid lives: a CUDA tensor
goes through ``csrc/marching_tet.cu`` (MT1 classifies the cubes, MT2 emits
the faces and interpolates the vertices; the JAX package's native pass,
``instant_nsr_pl_tpu/ops/native/marching_tet.cc``, is its counterpart), a
numpy array or a CPU tensor through :func:`marching_tetrahedra_numpy`, the
port's own copy of ``instant_nsr_pl_tpu/ops/isosurface.py`` (numpy only; the
port imports nothing of the JAX package) and the kernels' plain version: the
card returns the same vertices and faces, in the same order. Both replace the
reference's torchmcubes / PyMCubes dependency (reference:
models/geometry.py:32-112, requirements.txt:9). The level grid is evaluated
on the model's device (``models/isosurface.py``) and stays there.

Design (a clean-room implementation, no case tables copied):

- each grid cube is split into 6 tetrahedra sharing the main diagonal;
- a tetrahedron with a sign change contributes 1 or 2 triangles whose
  vertices lie on its edges, found by linear interpolation of the field;
- the 16 sign configurations are enumerated *programmatically* in
  ``_build_tet_table`` (1-inside -> tri, 2-inside -> quad, 3-inside -> tri);
- triangle orientation is fixed globally afterwards by comparing each face
  normal with the interpolated field gradient (normals point towards
  positive field values, i.e. outward for SDFs with inside < 0);
- vertices are welded by unique edge id so shared edges produce shared
  vertices (watertight within each marching domain).

On the card the kernels do all of it: MT1 classifies every grid line and
scans the counts (no ``nonzero``, no sort), MT2 writes the faces and the
vertices at the scanned offsets, and the host reads the totals once to size
the mesh (``csrc/marching_tet.cu`` says how the weld ranks the edges).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops import cuda_build

# The 8 cube corners in (x, y, z) bit order: corner i has coords
# ((i>>0)&1, (i>>1)&1, (i>>2)&1).
_CUBE_CORNERS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.int64
)

# 6 tetrahedra per cube, all containing the main diagonal corner0 -> corner7
# (0,0,0) -> (1,1,1). Corners listed by cube-corner index. Each consecutive
# pair of tets shares a face, so the decomposition is conforming: neighbors
# agree on the shared cube faces (each cube face is split along the diagonal
# that contains the face corner touching the main diagonal).
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)

# The 6 edges of a tetrahedron as (local vertex a, local vertex b), a < b.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)
_EDGE_OF_PAIR = {}
for _ei, (_a, _b) in enumerate(_TET_EDGES):
    _EDGE_OF_PAIR[(int(_a), int(_b))] = _ei
    _EDGE_OF_PAIR[(int(_b), int(_a))] = _ei


def _build_tet_table():
    """For each of the 16 inside-masks, the triangles as triples of tet-edge
    ids (padded with -1). At most 2 triangles per tet."""
    table = np.full((16, 2, 3), -1, dtype=np.int64)
    for mask in range(1, 15):
        inside = [v for v in range(4) if (mask >> v) & 1]
        outside = [v for v in range(4) if not ((mask >> v) & 1)]
        if len(inside) == 1:
            v = inside[0]
            e = [_EDGE_OF_PAIR[(v, o)] for o in outside]
            table[mask, 0] = e
        elif len(inside) == 3:
            v = outside[0]
            e = [_EDGE_OF_PAIR[(v, i)] for i in inside]
            table[mask, 0] = e
        else:  # 2 inside -> quad -> 2 triangles
            i0, i1 = inside
            o0, o1 = outside
            quad = [
                _EDGE_OF_PAIR[(i0, o0)],
                _EDGE_OF_PAIR[(i0, o1)],
                _EDGE_OF_PAIR[(i1, o1)],
                _EDGE_OF_PAIR[(i1, o0)],
            ]
            table[mask, 0] = [quad[0], quad[1], quad[2]]
            table[mask, 1] = [quad[0], quad[2], quad[3]]
    return table


_TET_TABLE = _build_tet_table()


def marching_tetrahedra(values, iso=0.0):
    """The iso-surface of a scalar grid ``values`` (Rx, Ry, Rz), indexed
    values[x, y, z], where it lives: MT1 / MT2 for a CUDA tensor (vertices
    (V, 3) float32 and faces (F, 3) int64 as tensors on its device), the
    numpy twin for a numpy array (numpy out) or a CPU tensor (tensors out).
    See :func:`marching_tetrahedra_numpy` for the conventions."""
    if not torch.is_tensor(values):
        return marching_tetrahedra_numpy(values, iso)
    if values.device.type == "cuda":
        return marching_tetrahedra_launch(values, iso)
    if values.device.type == "cpu":
        verts, faces = marching_tetrahedra_numpy(values.detach().numpy(), iso)
        return torch.from_numpy(verts), torch.from_numpy(faces)
    raise ValueError(f"marching_tetrahedra: unsupported device {values.device}")


def marching_tetrahedra_numpy(values, iso=0.0):
    """Extract the iso-surface of a scalar grid (the host twin of MT1 / MT2).

    Args:
      values: (Rx, Ry, Rz) float array, indexed values[x, y, z].
      iso: iso-value; "inside" means ``values < iso`` (SDF convention).
    Returns:
      verts: (V, 3) float32 in grid-index coordinates (0..R-1 per axis).
      faces: (F, 3) int64, oriented so normals point towards values > iso.
    """
    values = np.asarray(values, dtype=np.float32)
    rx, ry, rz = values.shape
    if min(rx, ry, rz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    nx, ny, nz = rx - 1, ry - 1, rz - 1
    flat = values.reshape(-1)

    # vertex linear index of every cube origin
    ox, oy, oz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    origin = (ox * ry + oy) * rz + oz  # (nx, ny, nz), x-major like values
    origin = origin.reshape(-1)  # (C,)

    # linear offsets of the 8 cube corners
    corner_off = (
        _CUBE_CORNERS[:, 0] * (ry * rz)
        + _CUBE_CORNERS[:, 1] * rz
        + _CUBE_CORNERS[:, 2]
    )  # (8,)

    cube_vidx = origin[:, None] + corner_off[None, :]  # (C, 8)
    # only keep cubes whose corner values straddle iso
    cube_vals = flat[cube_vidx]
    lo = cube_vals.min(axis=1)
    hi = cube_vals.max(axis=1)
    active = (lo < iso) & (hi >= iso)
    cube_vidx = cube_vidx[active]  # (A, 8)
    if cube_vidx.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # expand to tets: (A, 6, 4) global vertex ids
    tet_vidx = cube_vidx[:, _TETS].reshape(-1, 4)  # (T, 4)
    tet_vals = flat[tet_vidx]  # (T, 4)
    mask = (
        (tet_vals[:, 0] < iso).astype(np.int64)
        | ((tet_vals[:, 1] < iso) << 1)
        | ((tet_vals[:, 2] < iso) << 2)
        | ((tet_vals[:, 3] < iso) << 3)
    )
    keep = (mask != 0) & (mask != 15)
    tet_vidx = tet_vidx[keep]
    tet_vals = tet_vals[keep]
    mask = mask[keep]
    if tet_vidx.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tris = _TET_TABLE[mask]  # (T, 2, 3) tet-edge ids or -1
    tri_valid = tris[:, :, 0] >= 0  # (T, 2)
    t_idx, k_idx = np.nonzero(tri_valid)
    tri_edges = tris[t_idx, k_idx]  # (F, 3) tet-edge ids
    tri_tets = tet_vidx[t_idx]  # (F, 4) global vertex ids of owning tet
    tri_vals = tet_vals[t_idx]  # (F, 4)

    # each face vertex lies on a tet edge -> global (va, vb) vertex ids
    ea = _TET_EDGES[tri_edges, 0]  # (F, 3) local
    eb = _TET_EDGES[tri_edges, 1]
    ga = np.take_along_axis(tri_tets, ea, axis=1)  # (F, 3) global
    gb = np.take_along_axis(tri_tets, eb, axis=1)
    va = np.take_along_axis(tri_vals, ea, axis=1)
    vb = np.take_along_axis(tri_vals, eb, axis=1)

    # weld: unique key per undirected grid edge
    lo_id = np.minimum(ga, gb)
    hi_id = np.maximum(ga, gb)
    key = lo_id.astype(np.int64) * (rx * ry * rz) + hi_id
    uniq, faces = np.unique(key, return_inverse=True)
    faces = faces.reshape(-1, 3)

    # interpolate one representative per unique edge
    first = np.full(uniq.shape[0], -1, dtype=np.int64)
    flat_inv = faces.reshape(-1)
    # last occurrence wins; any representative of the same edge is identical
    first[flat_inv] = np.arange(flat_inv.shape[0])
    rep = first
    ga_f, gb_f = lo_id.reshape(-1)[rep], hi_id.reshape(-1)[rep]
    va_f = flat[ga_f]
    vb_f = flat[gb_f]
    denom = vb_f - va_f
    t = np.where(np.abs(denom) > 1e-12, (iso - va_f) / denom, 0.5)
    t = np.clip(t, 0.0, 1.0)

    def coords(ids):
        x = ids // (ry * rz)
        y = (ids // rz) % ry
        z = ids % rz
        return np.stack([x, y, z], axis=-1).astype(np.float32)

    pa, pb = coords(ga_f), coords(gb_f)
    verts = pa + t[:, None] * (pb - pa)

    # drop degenerate faces (two corners on the same welded vertex)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # orient: face normal should point towards increasing field (outside).
    # Use the field gradient at the face centroid via central differences on
    # the grid (nearest-cell sampling is sufficient for orientation).
    c = verts[faces].mean(axis=1)
    gidx = np.clip(np.round(c).astype(np.int64), 1, [rx - 2, ry - 2, rz - 2])
    gx = (
        values[gidx[:, 0] + 1, gidx[:, 1], gidx[:, 2]]
        - values[gidx[:, 0] - 1, gidx[:, 1], gidx[:, 2]]
    )
    gy = (
        values[gidx[:, 0], gidx[:, 1] + 1, gidx[:, 2]]
        - values[gidx[:, 0], gidx[:, 1] - 1, gidx[:, 2]]
    )
    gz = (
        values[gidx[:, 0], gidx[:, 1], gidx[:, 2] + 1]
        - values[gidx[:, 0], gidx[:, 1], gidx[:, 2] - 1]
    )
    grad = np.stack([gx, gy, gz], axis=-1)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    flip = (n * grad).sum(axis=1) < 0
    faces[flip] = faces[flip][:, ::-1]

    return verts.astype(np.float32), faces.astype(np.int64)


# ---------------------------------------------------------------------------
# the kernels (MT1, MT2)
# ---------------------------------------------------------------------------

LINES_PER_TILE = 32  # grid lines of an MT1 block, a tile (marching_tet.cu kTileLines)
NARROW_POINTS = 2 ** 31  # grids of fewer points run with 32-bit offsets


class Classified(NamedTuple):
    """MT1's output for MT2: a byte per grid vertex (its mesh edges by rank,
    bits 0-6; its cube active, bit 7), each line's faces, vertices and mask
    of chunks with a non-zero byte, each tile's counts and first face and
    vertex, the totals (active cubes, faces, vertices) on the card, and the
    offset width."""

    flags: torch.Tensor
    line_info: torch.Tensor
    tile_sums: torch.Tensor
    tile_bases: torch.Tensor
    totals: torch.Tensor
    wide: bool


def _grid_args(values):
    rx, ry, rz = (int(d) for d in values.shape)
    return values.data_ptr(), rx, ry, rz


def _empty_mesh(device):
    return (torch.zeros((0, 3), dtype=torch.float32, device=device),
            torch.zeros((0, 3), dtype=torch.int64, device=device))


def marching_tetrahedra_launch(values, iso=0.0, stages=None):
    """Marching tetrahedra of a CUDA grid: MT1 (:func:`marching_classify`),
    then MT2 (:func:`marching_emit`). Returns (verts (V, 3) float32, faces
    (F, 3) int64) on the grid's device, equal to
    :func:`marching_tetrahedra_numpy`'s. ``stages``, a callable, is called
    with each stage's name after its work is queued (``tools/mt_bench.py``
    records a CUDA event there)."""
    if values.dim() != 3:
        raise ValueError(f"marching_tetrahedra: a 3-D grid, got {tuple(values.shape)}")
    values = values.float().contiguous()
    if min(values.shape) < 2:
        return _empty_mesh(values.device)
    iso = float(np.float32(iso))
    classified = marching_classify(values, iso, stages=stages)
    return marching_emit(values, iso, classified, stages=stages)


def marching_classify(values, iso, wide=None, stages=None):
    """MT1 for a contiguous float32 CUDA grid: ``mt_classify`` (the flags
    and counts) and ``mt_scan`` (the tiles' first faces and vertices, the
    totals). ``wide`` asks for 64-bit offsets (None: from 2^31 points on).
    Returns a :class:`Classified`; nothing is read back."""
    rx, ry, rz = (int(d) for d in values.shape)
    wide = values.numel() >= NARROW_POINTS if wide is None else bool(wide)
    n_lines = rx * ry
    n_tiles = -(-n_lines // LINES_PER_TILE)
    device = values.device
    flags = torch.empty((values.numel(),), dtype=torch.uint8, device=device)
    line_info = torch.empty((n_lines, 4), dtype=torch.int32, device=device)
    tile_sums = torch.empty((n_tiles, 3), dtype=torch.int64, device=device)
    tile_bases = torch.empty((n_tiles, 2), dtype=torch.int64, device=device)
    totals = torch.empty((3,), dtype=torch.int64, device=device)
    classify = cuda_build.entry("marching_tet", "mt_classify", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p])
    scan = cuda_build.entry("marching_tet", "mt_scan", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = classify(*_grid_args(values), iso, int(wide), flags.data_ptr(),
                      line_info.data_ptr(), tile_sums.data_ptr(), stream)
        cuda_build.check(rc, "marching_classify", _SUPPORTED)
        if stages:
            stages("mt_classify")
        rc = scan(tile_sums.data_ptr(), n_tiles, tile_bases.data_ptr(), totals.data_ptr(), stream)
        cuda_build.check(rc, "marching_classify", _SUPPORTED)
        if stages:
            stages("mt_scan")
    marching_classify.launches += 1
    return Classified(flags, line_info, tile_sums, tile_bases, totals, wide)


marching_classify.launches = 0
_SUPPORTED = ("axes of 2 to 2^24 - 1 points; 32-bit offsets below 2^31 points, 64-bit "
              "offsets at any size")


def marching_emit(values, iso, classified, stages=None):
    """MT2 for MT1's ``classified``: the pass's one host sync reads the
    totals to size the mesh, then ``mt_emit`` writes the faces and
    ``mt_verts`` the vertices at the offsets MT1 scanned. Counts one launch
    per call with a non-empty surface; with none it launches nothing."""
    device = values.device
    n_faces, n_verts = (int(n) for n in classified.totals[1:].tolist())
    if stages:
        stages("sync")
    if n_faces == 0:
        return _empty_mesh(device)
    faces = torch.empty((n_faces, 3), dtype=torch.int64, device=device)
    verts = torch.empty((n_verts, 3), dtype=torch.float32, device=device)
    args = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
    emit = cuda_build.entry("marching_tet", "mt_emit", args)
    interp = cuda_build.entry("marching_tet", "mt_verts", args)
    common = (*_grid_args(values), iso, int(classified.wide), classified.flags.data_ptr(),
              classified.line_info.data_ptr(), classified.tile_bases.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = emit(*common, faces.data_ptr(), stream)
        cuda_build.check(rc, "marching_emit", _SUPPORTED)
        if stages:
            stages("mt_emit")
        rc = interp(*common, verts.data_ptr(), stream)
        cuda_build.check(rc, "marching_emit", _SUPPORTED)
        if stages:
            stages("mt_verts")
    marching_emit.launches += 1
    return verts, faces


marching_emit.launches = 0
