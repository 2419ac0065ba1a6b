"""Ray generation and ray/AABB intersection.

Port of ``instant_nsr_pl_tpu/ops/ray.py`` (the reference's
``models/ray_utils.py`` and nerfacc's ``ray_aabb_intersect``), with the same
float expressions so both packages give bit-identical rays and ranges.
"""

from __future__ import annotations

import numpy as np
import torch


def get_ray_directions(w, h, fx, fy, cx, cy, use_pixel_centers=True):
    """Per-pixel camera-space ray directions, OpenGL convention (-z forward,
    +y up). Reference: models/ray_utils.py:9-20. Computed in numpy once per
    dataset; returns an (H, W, 3) float32 array."""
    pixel_center = 0.5 if use_pixel_centers else 0.0
    i, j = np.meshgrid(
        np.arange(w, dtype=np.float32) + pixel_center,
        np.arange(h, dtype=np.float32) + pixel_center,
        indexing="xy",
    )
    directions = np.stack(
        [(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1
    )
    return directions.astype(np.float32)


def _rotate(directions, rot):
    """(..., 3) directions times (..., 3, 3) rotations, summed left to right
    as the JAX twin's size-3 reduction does."""
    d = directions[..., None, :] * rot
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def get_rays(directions, c2w, keepdim=False):
    """Rotate camera-space directions into world space and broadcast origins.

    Reference: models/ray_utils.py:23-43. Supports directions (N, 3) with c2w
    (N, 3, 4) or (3, 4), and directions (H, W, 3) with c2w (3, 4) or
    (N, 3, 4)."""
    if directions.ndim == 2:  # (N, 3)
        if c2w.ndim == 2:
            c2w = c2w[None]
        rays_d = _rotate(directions, c2w[:, :3, :3])
        rays_o = c2w[:, :3, 3].expand(rays_d.shape)
    elif directions.ndim == 3:  # (H, W, 3)
        if c2w.ndim == 2:
            rays_d = _rotate(directions, c2w[None, None, :3, :3])
            rays_o = c2w[None, None, :3, 3].expand(rays_d.shape)
        else:  # (N, 3, 4) -> (N, H, W, 3)
            rays_d = _rotate(directions[None], c2w[:, None, None, :3, :3])
            rays_o = c2w[:, None, None, :3, 3].expand(rays_d.shape)
    else:
        raise ValueError(f"bad directions shape {tuple(directions.shape)}")
    if not keepdim:
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
    return rays_o, rays_d


def ray_aabb_intersect(rays_o, rays_d, aabb_min, aabb_max, miss_value=1e10):
    """Slab test: per-ray entry/exit t against an axis-aligned box, with
    nerfacc's semantics (t clamped to >= 0; both ``miss_value`` = 1e10 when the
    ray misses). Returns (t_min, t_max), each (...,)."""
    small = torch.full_like(rays_d, 1e-10)
    inv_d = 1.0 / torch.where(rays_d.abs() > 1e-10, rays_d, small)
    t0 = (aabb_min - rays_o) * inv_d
    t1 = (aabb_max - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    t_near = torch.clamp(t_near, min=0.0)
    hit = t_far >= t_near
    miss = torch.full_like(t_near, miss_value)
    return torch.where(hit, t_near, miss), torch.where(hit, t_far, miss)
