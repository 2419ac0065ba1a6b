"""Chamfer distance of an exported mesh against the procedural scene's
analytic surface (the union of spheres of ``datasets/synthetic.py``). The
port's copy of ``scripts/eval_chamfer.py``.

The reference publishes no chamfer numbers and ships no code for them; the
procedural scene has an exact surface, so its chamfer is exact rather than
scan-limited.

- mesh -> surface: the mean unsigned distance of area-weighted mesh samples
  (for a union of spheres, min_i ||p - c_i| - r_i| is the exact unsigned
  distance near the surface, where mesh points lie);
- surface -> mesh: the mean nearest-neighbour distance from exact surface
  samples (per sphere, area-weighted, points inside another sphere dropped)
  to the mesh samples;
- ``chamfer_exterior``: the same with mesh samples inside the solid (signed
  distance < -0.01, interior shells no camera sees) dropped, the analytic
  counterpart of DTU's observation mask.

    python -m instant_nsr_pl_tpu_torch.tools.eval_chamfer --exp_dir <dir> | --mesh path.obj

takes the newest ``.obj`` under ``<dir>/**/save`` (and a ``dataset.spheres``
override from the run's ``config/parsed.yaml``) and prints one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from instant_nsr_pl_tpu_torch.datasets.synthetic import _DEFAULT_SPHERES
from instant_nsr_pl_tpu_torch.utils.chamfer import sample_mesh_surface
from instant_nsr_pl_tpu_torch.utils.savers import load_obj


def surface_samples(spheres, n_per_sphere=60000, seed=0):
    """Exact area-weighted samples of the union-of-spheres surface."""
    rng = np.random.RandomState(seed)
    pts = []
    for ci, (c, r, _a) in enumerate(spheres):
        d = rng.normal(size=(n_per_sphere, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = np.asarray(c)[None] + r * d
        keep = np.ones(len(p), bool)
        for cj, (c2, r2, _a2) in enumerate(spheres):
            if cj != ci:
                keep &= np.linalg.norm(p - np.asarray(c2)[None], axis=1) >= r2
        pts.append(p[keep])
    return np.concatenate(pts, axis=0)


def unsigned_distance(points, spheres):
    """Exact unsigned distance to the union surface near the surface."""
    d = np.full(len(points), np.inf)
    for c, r, _a in spheres:
        d = np.minimum(d, np.abs(np.linalg.norm(points - np.asarray(c)[None], axis=1) - r))
    return d


def mesh_chamfer(mesh, spheres=_DEFAULT_SPHERES, n_points=100000):
    """The chamfer figures of ``mesh`` ({'v_pos', 't_pos_idx'}) against the
    analytic surface of ``spheres``."""
    from scipy.spatial import cKDTree

    mesh_pts = sample_mesh_surface(mesh["v_pos"], mesh["t_pos_idx"], n_points=n_points)
    if len(mesh_pts) == 0:
        raise ValueError("mesh_chamfer: the mesh has no area")
    d_mesh_to_gt = unsigned_distance(mesh_pts, spheres)
    gt_pts = surface_samples(spheres)
    d_gt_to_mesh, _ = cKDTree(mesh_pts).query(gt_pts, k=1, workers=-1)
    sd = np.full(len(mesh_pts), np.inf)
    for c, r, _a in spheres:
        sd = np.minimum(sd, np.linalg.norm(mesh_pts - np.asarray(c)[None], axis=1) - r)
    ext = sd > -0.01
    d_ext = d_mesh_to_gt[ext]
    return {
        "n_mesh_points": int(len(mesh_pts)),
        "chamfer": float(0.5 * (d_mesh_to_gt.mean() + d_gt_to_mesh.mean())),
        "mesh_to_gt_mean": float(d_mesh_to_gt.mean()),
        "gt_to_mesh_mean": float(d_gt_to_mesh.mean()),
        "mesh_to_gt_p95": float(np.percentile(d_mesh_to_gt, 95)),
        "gt_to_mesh_p95": float(np.percentile(d_gt_to_mesh, 95)),
        "chamfer_exterior": float(0.5 * (d_ext.mean() + d_gt_to_mesh.mean())),
        "exterior_frac": float(ext.mean()),
    }


def _spheres_of_run(exp_dir):
    """A ``dataset.spheres`` override from the run's parsed config, else the
    default scene (chamfer against the wrong surface would be meaningless)."""
    parsed = glob.glob(os.path.join(exp_dir, "**", "config", "parsed.yaml"), recursive=True)
    if parsed:
        from instant_nsr_pl_tpu_torch.config import load_config

        ds = load_config(sorted(parsed)[-1]).dataset
        if "spheres" in ds:
            return [(tuple(s[:3]), float(s[3]), tuple(s[4:7])) for s in ds["spheres"]]
    return _DEFAULT_SPHERES


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp_dir", default=None)
    p.add_argument("--mesh", default=None)
    p.add_argument("--n_points", type=int, default=100000)
    args = p.parse_args(argv)

    mesh_path, spheres = args.mesh, _DEFAULT_SPHERES
    if args.exp_dir:
        spheres = _spheres_of_run(args.exp_dir)
    if mesh_path is None:
        if not args.exp_dir:
            p.error("need --exp_dir or --mesh")
        objs = sorted(set(glob.glob(os.path.join(args.exp_dir, "**", "save", "*.obj"),
                                    recursive=True)), key=os.path.getmtime)
        if not objs:
            p.error(f"no .obj under {args.exp_dir}/**/save")
        mesh_path = objs[-1]
    out = {"mesh": mesh_path, **mesh_chamfer(load_obj(mesh_path), spheres, args.n_points)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
