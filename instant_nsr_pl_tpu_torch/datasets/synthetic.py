"""Procedural synthetic dataset: analytic renders of simple solids.

The port's own copy of ``instant_nsr_pl_tpu/datasets/synthetic.py`` (numpy
only; the port imports nothing of the JAX package).

Not present in the reference (which ships no tests and assumes downloaded
NeRF-Synthetic data); this module generates a fully view-consistent scene in
memory so end-to-end training, tests and benchmarks run without any files on
disk. The scene is a lambertian-shaded union of colored spheres rendered by
exact ray-sphere intersection — a radiance field a NeRF/NeuS model can fit,
with ground-truth SDF and masks for metric checks.
"""

from __future__ import annotations

import math

import numpy as np

from instant_nsr_pl_tpu_torch.ops.ray import get_ray_directions
from instant_nsr_pl_tpu_torch.registry import datasets


_DEFAULT_SPHERES = (
    # (center, radius, albedo)
    ((0.0, 0.0, 0.0), 0.5, (0.8, 0.3, 0.2)),
    ((0.45, 0.2, 0.3), 0.22, (0.2, 0.7, 0.3)),
    ((-0.4, -0.25, 0.2), 0.18, (0.25, 0.35, 0.9)),
)

_LIGHT_DIR = np.array([0.5, 0.7, 0.6], np.float32)
_LIGHT_DIR /= np.linalg.norm(_LIGHT_DIR)


def scene_sdf(points, spheres=_DEFAULT_SPHERES):
    """Ground-truth SDF of the sphere union at world points (..., 3)."""
    d = np.full(points.shape[:-1], np.inf, np.float32)
    for (c, r, _a) in spheres:
        d = np.minimum(
            d, np.linalg.norm(points - np.asarray(c, np.float32), axis=-1) - r
        )
    return d


def _render_view(rays_o, rays_d, spheres):
    """Exact ray-trace of the sphere union with lambertian shading.

    Returns rgb (N, 3) on white background and the hit mask (N,).
    """
    n = rays_o.shape[0]
    best_t = np.full((n,), np.inf, np.float32)
    best_normal = np.zeros((n, 3), np.float32)
    best_albedo = np.zeros((n, 3), np.float32)
    for (c, r, a) in spheres:
        c = np.asarray(c, np.float32)
        oc = rays_o - c
        b = (oc * rays_d).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= t > 1e-3
        closer = hit & (t < best_t)
        best_t = np.where(closer, t, best_t)
        p = rays_o + rays_d * t[:, None]
        normal = (p - c) / r
        best_normal = np.where(closer[:, None], normal, best_normal)
        best_albedo = np.where(
            closer[:, None], np.asarray(a, np.float32), best_albedo
        )
    mask = np.isfinite(best_t)
    shade = np.clip((best_normal * _LIGHT_DIR).sum(-1), 0.0, 1.0) * 0.7 + 0.3
    rgb = best_albedo * shade[:, None]
    rgb = np.where(mask[:, None], rgb, 1.0)  # white background
    return rgb.astype(np.float32), mask.astype(np.float32)


def look_at_c2w(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """OpenGL-convention camera-to-world (camera looks along -z)."""
    eye = np.asarray(eye, np.float32)
    forward = np.asarray(target, np.float32) - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    rot = np.stack([right, true_up, -forward], axis=-1)  # columns x, y, -z
    return np.concatenate([rot, eye[:, None]], axis=1).astype(np.float32)  # (3,4)


def _spheres_from_config(config):
    """Optional scene override: ``spheres: [[cx,cy,cz,r, R,G,B], ...]``."""
    if "spheres" not in config:
        return _DEFAULT_SPHERES
    out = []
    for s in config["spheres"]:
        s = list(s)
        out.append((tuple(s[0:3]), float(s[3]), tuple(s[4:7])))
    return tuple(out)


class SyntheticDatasetBase:
    def setup(self, config, split):
        self.config = config
        self.split = split
        w = h = int(config.get("size", 96))
        n_images = {
            "train": int(config.get("n_train", 24)),
            "val": int(config.get("n_val", 2)),
            "test": int(config.get("n_test", 4)),
        }.get(split, 4)
        cam_dist = float(config.get("cam_dist", 2.5))
        fov = float(config.get("fov", 0.8))  # radians

        self.w, self.h = w, h
        self.img_wh = (w, h)
        focal = 0.5 * w / math.tan(0.5 * fov)
        self.directions = get_ray_directions(w, h, focal, focal, w / 2, h / 2)
        self.has_mask = True
        self.apply_mask = bool(config.get("apply_mask", True))

        # deterministic per-split camera rings at different elevations
        seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        rng = np.random.RandomState(seed)
        phis = np.linspace(0.0, 2.0 * math.pi, n_images, endpoint=False)
        phis += rng.uniform(0, 2 * math.pi / max(n_images, 1))
        thetas = rng.uniform(0.35, 1.1, size=n_images)

        spheres = _spheres_from_config(config)
        self.spheres = spheres
        dirs_flat = self.directions.reshape(-1, 3)
        c2w_list, img_list, mask_list = [], [], []
        for phi, theta in zip(phis, thetas):
            eye = cam_dist * np.array(
                [
                    math.cos(phi) * math.sin(theta),
                    math.sin(phi) * math.sin(theta),
                    math.cos(theta),
                ],
                np.float32,
            )
            c2w = look_at_c2w(eye)
            rays_d = dirs_flat @ c2w[:3, :3].T
            rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
            rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
            rgb, mask = _render_view(rays_o, rays_d, spheres)
            c2w_list.append(c2w)
            img_list.append(rgb.reshape(h, w, 3))
            mask_list.append(mask.reshape(h, w))

        self.all_c2w = np.stack(c2w_list)
        self.all_images = np.stack(img_list)
        self.all_fg_masks = np.stack(mask_list)


@datasets.register("synthetic")
class SyntheticDataModule:
    def __init__(self, config):
        self.config = config
        self._splits = {}

    def setup(self, stage=None):
        wanted = {
            "fit": ["train", "val"],
            "validate": ["val"],
            "test": ["test"],
            "predict": ["train"],
        }.get(stage or "fit")
        for split in wanted:
            if split not in self._splits:
                ds = SyntheticDatasetBase()
                ds.setup(self.config, split)
                self._splits[split] = ds

    def split(self, name):
        return self._splits[name]

    @property
    def train(self):
        return self._splits["train"]

    @property
    def val(self):
        return self._splits["val"]

    @property
    def test(self):
        return self._splits["test"]

    @property
    def predict(self):
        return self._splits["train"]
