"""Chamfer distance between a mesh and a reference surface.

The port's copy of ``instant_nsr_pl_tpu/utils/chamfer.py``. Not present in
the reference (it publishes no chamfer numbers and has no code for them);
this is the standard DTU-style evaluation: sample points on both surfaces
and take the symmetric mean nearest-neighbour distance with a cKDTree.
"""

from __future__ import annotations

import numpy as np


def sample_mesh_surface(v_pos, t_pos_idx, n_points=100000, seed=0):
    """Uniform area-weighted surface samples (n_points, 3)."""
    rng = np.random.RandomState(seed)
    v = np.asarray(v_pos, np.float64)
    f = np.asarray(t_pos_idx, np.int64)
    tri = v[f]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0 or len(f) == 0:
        return np.zeros((0, 3))
    probs = area / total
    choice = rng.choice(len(f), size=n_points, p=probs)
    u = rng.rand(n_points, 1)
    v_ = rng.rand(n_points, 1)
    flip = (u + v_) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v_ = np.where(flip, 1.0 - v_, v_)
    t = tri[choice]
    return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v_ * (t[:, 2] - t[:, 0])


def chamfer_distance(mesh_a, mesh_b, n_points=100000, seed=0, max_dist=None):
    """Symmetric chamfer: the mean of the two directed mean nearest-neighbour
    distances.

    ``mesh_*``: dicts with 'v_pos' (V, 3) and 't_pos_idx' (F, 3), or point
    arrays (N, 3). ``max_dist`` clips outlier distances (the DTU protocol
    clips at 20 mm in scene units). Returns a dict with 'accuracy' (a -> b),
    'completeness' (b -> a) and 'chamfer'.
    """
    from scipy.spatial import cKDTree

    def pts(m, seed_off):
        if isinstance(m, dict):
            return sample_mesh_surface(m["v_pos"], m["t_pos_idx"], n_points, seed + seed_off)
        return np.asarray(m, np.float64)

    pa = pts(mesh_a, 0)
    pb = pts(mesh_b, 1)
    if len(pa) == 0 or len(pb) == 0:
        return {"accuracy": np.inf, "completeness": np.inf, "chamfer": np.inf}
    da = cKDTree(pb).query(pa, k=1)[0]
    db = cKDTree(pa).query(pb, k=1)[0]
    if max_dist is not None:
        da = np.minimum(da, max_dist)
        db = np.minimum(db, max_dist)
    acc = float(da.mean())
    comp = float(db.mean())
    return {"accuracy": acc, "completeness": comp, "chamfer": 0.5 * (acc + comp)}
