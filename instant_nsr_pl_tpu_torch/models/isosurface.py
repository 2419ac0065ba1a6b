"""Two-stage isosurface extraction for implicit geometries.

Port of ``instant_nsr_pl_tpu/models/isosurface.py`` (the reference's
``MarchingCubeHelper`` + ``BaseImplicitGeometry.isosurface``,
models/geometry.py:32-112): a coarse pass over the full ``[-r, r]^3`` cube
locates the surface, a fine pass re-extracts inside the 10%-padded bounding
box of the coarse mesh. The grid points are built in numpy and evaluated on
the geometry's device in fixed-size chunks under ``torch.no_grad`` (encoding +
MLP per grid point, K1, K5, HG1 or VM1 on the card); the level grid stays on
that device and is triangulated there (``ops/isosurface.py``: MT1 / MT2 on
the card, the numpy twin on the CPU). Only the vertices and faces come back
to the host.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops.isosurface import marching_tetrahedra


def _eval_level_grid(geometry, params, vmin, vmax, resolution, chunk, device, step=None):
    """Evaluate ``geometry.forward_level`` on a regular grid, in chunks of
    ``chunk`` points, or one chunk of the whole grid where it is smaller (the
    tail padded to a full chunk, as the JAX package pads it to compile
    once). Returns a (resolution,)*3 float32 tensor on ``device``, indexed
    values[x, y, z]."""
    axes = [np.linspace(vmin[i], vmax[i], resolution, dtype=np.float32) for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    n = pts.shape[0]
    chunk = min(chunk, n)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    t0 = last_beat = time.time()
    with torch.no_grad():
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            block = pts[start:end]
            if block.shape[0] < chunk:
                block = np.concatenate([block, np.zeros((chunk - block.shape[0], 3), np.float32)])
            vals = geometry.forward_level(params, torch.from_numpy(block).to(device), step=step)
            out[start:end] = vals[: end - start].float()
            if time.time() - last_beat > 60.0:
                print(f"[isosurface] {end}/{n} points ({time.time() - t0:.0f}s)", flush=True,
                      file=sys.stderr)
                last_beat = time.time()
    return out.reshape(resolution, resolution, resolution)


def chunked_point_eval(fn, points, chunk, device):
    """Apply ``fn`` (tensor-valued, leading axis = points) over ``points``
    (N, 3) in fixed-size padded chunks on ``device``; returns numpy. The
    reference's ``chunk_batch(..., export.chunk_size, ...)`` for vertex
    attributes at export (reference models/nerf.py:156,
    models/neus.py:317). On a device out-of-memory error (and only on that)
    the chunk halves, down to 4,096 points, and the sweep starts again; every
    other error propagates."""
    points = np.asarray(points, np.float32)
    chunk = int(chunk)
    while True:
        try:
            return _chunk_sweep(fn, points, chunk, device)
        except torch.OutOfMemoryError:
            if chunk <= 4096:
                raise
            chunk //= 2
            torch.cuda.empty_cache()
            print(f"[export] point eval out of device memory: retrying at chunk={chunk}",
                  flush=True)


def _chunk_sweep(fn, points, chunk, device):
    n = points.shape[0]
    outs = []
    for start in range(0, max(n, 1), chunk):
        end = min(start + chunk, n)
        block = points[start:end]
        if n > chunk and block.shape[0] < chunk:
            block = np.concatenate([block, np.zeros((chunk - block.shape[0], 3), np.float32)])
        out = fn(torch.from_numpy(block).to(device))
        outs.append(out[: end - start].float().cpu().numpy())
    return np.concatenate(outs)


def _extract(values, vmin, vmax, iso=0.0):
    """Triangulate the level grid where it lives (a tensor on its device,
    or a numpy array on the host); the mesh in world coordinates as numpy
    (``v_pos`` (V, 3) float32, ``t_pos_idx`` (F, 3) int64)."""
    verts, faces = marching_tetrahedra(values, iso)
    if torch.is_tensor(verts):
        verts, faces = verts.cpu().numpy(), faces.cpu().numpy()
    res = np.asarray(values.shape, np.float32)
    scale = (np.asarray(vmax) - np.asarray(vmin)) / np.maximum(res - 1.0, 1.0)
    v_world = verts * scale[None, :] + np.asarray(vmin, np.float32)[None, :]
    return {"v_pos": v_world.astype(np.float32), "t_pos_idx": faces}


def extract_isosurface(geometry, params, device, step=None):
    """Two-stage extraction (coarse full-cube pass -> padded-bbox fine pass).

    ``geometry`` exposes ``forward_level(params, points, step=step)``
    (negative inside; ``step`` the training step, None outside training)
    and carries ``radius`` and ``config.isosurface`` with ``resolution``,
    optional ``chunk`` and ``threshold`` (the surface lies at level ==
    -threshold: a density geometry's level is -density). ``device``: where
    the level grid is evaluated (the parameters' device)."""
    iso_cfg = geometry.config.get("isosurface", None)
    if iso_cfg is None:
        raise ValueError("geometry config has no `isosurface` section")
    resolution = int(iso_cfg["resolution"])
    chunk = int(iso_cfg.get("chunk", 2097152))
    iso = -float(iso_cfg.get("threshold", 0.0))
    r = float(geometry.radius)

    vmin = np.array([-r, -r, -r], np.float32)
    vmax = np.array([r, r, r], np.float32)
    coarse_vals = _eval_level_grid(geometry, params, vmin, vmax, resolution, chunk, device, step)
    coarse = _extract(coarse_vals, vmin, vmax, iso=iso)
    if coarse["v_pos"].shape[0] == 0:
        return coarse

    # fine pass over the 10%-padded coarse bbox (reference models/geometry.py:106-111)
    c_min = coarse["v_pos"].min(axis=0)
    c_max = coarse["v_pos"].max(axis=0)
    pad = 0.1 * (c_max - c_min)
    f_min = np.maximum(c_min - pad, vmin)
    f_max = np.minimum(c_max + pad, vmax)
    fine_vals = _eval_level_grid(geometry, params, f_min, f_max, resolution, chunk, device, step)
    return _extract(fine_vals, f_min, f_max, iso=iso)
