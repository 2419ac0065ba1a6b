"""Instant-NGP style NeRF renderer.

Port of ``instant_nsr_pl_tpu/models/nerf.py:37-250`` (reference
models/nerf.py:14-161). Bounded scenes: AABB contraction, a 128^3 occupancy
grid and its update, uniform (optionally stratified) stepping ``1.732 * 2r /
num_samples``. Unbounded scenes (``learned_background``, reference
models/nerf.py:21-26): sphere contraction, a 256^3 grid in contracted space,
near / far 0.2 / 1e4 and cone-angle stepping from a 0.01 base step, one grid
probe per sample. Both run the static-capacity packed march of
``ops/marching.py`` and composite on the packed buffer. The training forward
is differentiable with respect to the parameters; the eval forward runs
without autograd. ``export`` extracts the mesh, with vertex colours seen from
-z on request (JAX ``models/nerf.py:252-301``).
"""

from __future__ import annotations

import contextlib
import math

import torch

from instant_nsr_pl_tpu_torch.device import resolve_device
from instant_nsr_pl_tpu_torch.models.isosurface import chunked_point_eval
from instant_nsr_pl_tpu_torch.models.network_utils import params_device
from instant_nsr_pl_tpu_torch.ops.contraction import ContractionType
from instant_nsr_pl_tpu_torch.ops.marching import (
    OccGridSpec,
    march_rays,
    occupancy_grid_init,
    occupancy_grid_update,
    packed_positions,
)
from instant_nsr_pl_tpu_torch.ops.ray import ray_aabb_intersect
from instant_nsr_pl_tpu_torch.ops.rendering import (
    accumulate_along_rays,
    render_weight_from_density,
)
from instant_nsr_pl_tpu_torch.registry import models


@models.register("nerf")
class NeRFModel:
    def __init__(self, config):
        self.config = config
        self.radius = float(config.radius)
        self.geometry = models.make(config.geometry.name, config.geometry)
        self.texture = models.make(config.texture.name, config.texture)
        self.num_samples_per_ray = int(config.num_samples_per_ray)

        self.learned_background = bool(config.get("learned_background", False))
        if self.learned_background:
            self.occupancy_grid_res = 256
            self.near_plane, self.far_plane = 0.2, 1e4
            self.cone_angle = 10.0 ** (math.log10(self.far_plane) / self.num_samples_per_ray) - 1.0
            self.render_step_size = 0.01
            self.contraction_type = ContractionType.UN_BOUNDED_SPHERE
        else:
            self.occupancy_grid_res = 128
            self.near_plane, self.far_plane = None, None
            self.cone_angle = 0.0
            self.render_step_size = 1.732 * 2.0 * self.radius / self.num_samples_per_ray
            self.contraction_type = ContractionType.AABB
        self.geometry.contraction_type = self.contraction_type

        self.grid_prune = bool(config.get("grid_prune", True))
        self.occ_thre = float(config.get("grid_prune_occ_thre", 0.01))
        self.occ_spec = OccGridSpec(
            resolution=self.occupancy_grid_res,
            radius=self.radius,
            contraction_type=self.contraction_type,
        )
        # strided occupancy probing (uniform steps only): one dilated-grid
        # probe per group of k samples, k bounded so a group stays within one
        # dilation radius
        if self.cone_angle == 0.0:
            cell = 2.0 * self.radius / self.occupancy_grid_res
            auto = int(2.0 * cell / self.render_step_size)
            self.occ_stride = int(config.get("grid_lookup_stride", min(8, max(1, auto))))
            while self.num_samples_per_ray % self.occ_stride:
                self.occ_stride -= 1
        else:
            self.occ_stride = 1
        self.group_compact = bool(config.get("march_group_compact", True))
        # hash-grid per-group tap dedup (JAX models/nerf.py:87-106): with
        # aligned k-blocks guaranteed by the group-compacted march, the
        # geometry's hash encoding keeps the dedup spec (its kernels compute
        # per-sample taps, the same function); a stride > 1 means AABB and
        # uniform steps
        if (bool(config.get("hash_tap_dedup", True)) and self.group_compact
                and self.grid_prune and self.occ_stride > 1):
            self.geometry.configure_dedup(self.occ_stride,
                                          self.render_step_size / (2.0 * self.radius))

    def packed_group(self, capacity: int) -> int:
        """Block size of the packed buffer: k when the group-compacted march
        guarantees single-ray aligned k-blocks, else 1."""
        if (
            self.group_compact
            and self.grid_prune
            and self.occ_stride > 1
            and capacity % self.occ_stride == 0
        ):
            return self.occ_stride
        return 1

    # -- state ------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None):
        """Parameters drawn from ``generator`` (on the CPU, so a seed gives
        the same weights on every device), placed on ``device``."""
        dev = resolve_device(device)
        return {
            "geometry": self.geometry.init(generator, dev),
            "texture": self.texture.init(generator, dev),
        }

    def init_occupancy(self, device=None):
        return {"grid": occupancy_grid_init(self.occ_spec, device)}

    # -- occupancy maintenance (reference models/nerf.py:45-55) -----------
    def update_occupancy(self, params, occ, generator, warmup=False, phase=None, step=None,
                         group=None):
        """One grid update (``ops/marching.py`` ``occupancy_grid_update``)
        with occupancy = density * step size, the reference's Taylor
        approximation of 1 - exp(-density * dt). The density comes from
        ``geometry.apply`` at training step ``step``, so the fused density op
        (K1) evaluates it, in chunks of 2^18 points."""
        if not self.grid_prune:
            return occ

        def occ_eval_fn(x):
            density = [self.geometry.apply(params["geometry"], c, step=step)[0]
                       for c in x.split(1 << 18)]
            return torch.cat(density) * self.render_step_size

        grid = occupancy_grid_update(
            occ["grid"], self.occ_spec, occ_eval_fn, generator,
            occ_thre=self.occ_thre, warmup=warmup, phase=phase, group=group,
        )
        return {"grid": grid}

    # -- rendering ---------------------------------------------------------
    def march(self, occ, rays_o, rays_d, capacity: int, jitter=None):
        """Slab test (near / far planes for an unbounded scene),
        occupancy-pruned march and sample positions: (samples, positions,
        dirs, t_mid, group). ``jitter``: the (R,) uniform draws of a
        stratified march."""
        if self.learned_background:
            t_min = torch.full((rays_o.shape[0],), self.near_plane, device=rays_o.device)
            t_max = torch.full((rays_o.shape[0],), self.far_plane, device=rays_o.device)
        else:
            t_min, t_max = ray_aabb_intersect(rays_o, rays_d, -self.radius, self.radius)
        grp = self.packed_group(capacity)
        grid = occ["grid"]
        samples = march_rays(
            rays_o,
            rays_d,
            t_min,
            t_max,
            render_step_size=self.render_step_size,
            max_samples=self.num_samples_per_ray,
            capacity=capacity,
            occ_binary=grid.binary if self.grid_prune else None,
            occ_spec=self.occ_spec,
            occ_dilated=grid.binary_dilated if self.grid_prune else None,
            occ_stride=self.occ_stride,
            group_compact=grp > 1,
            jitter=jitter,
            cone_angle=self.cone_angle,
        )
        positions, dirs, t_mid, _ = packed_positions(samples, rays_o, rays_d, group=grp)
        return samples, positions, dirs, t_mid, grp

    @staticmethod
    def composite(samples, density, rgb, t_mid, background_color, group):
        """Weights from density, then (opacity, depth, rgb) per ray in one
        segment sum, and the background ((3,) or (N, 3)) blended by
        (1 - opacity). Also returns the packed ``weights``. NeuS's learned
        background composites the same way."""
        weights = render_weight_from_density(
            samples.t_starts, samples.t_ends, density,
            samples.ray_indices, samples.valid, group=group,
        )
        vals = torch.cat([torch.ones_like(t_mid)[:, None], t_mid[:, None], rgb], dim=-1)
        acc = accumulate_along_rays(
            weights, vals, samples.ray_ends, valid=samples.valid, group=group
        )
        opacity, depth, comp_rgb = acc[:, 0:1], acc[:, 1:2], acc[:, 2:5]
        bg = torch.as_tensor(background_color, dtype=comp_rgb.dtype, device=comp_rgb.device)
        comp_rgb = comp_rgb + bg.expand_as(comp_rgb) * (1.0 - opacity)
        return {
            "comp_rgb": comp_rgb,
            "opacity": opacity,
            "depth": depth,
            "rays_valid": opacity > 0,
            "rays_kept": samples.ray_kept,
            "num_samples": samples.num_valid,
            "weights": weights,
        }

    def forward(self, params, occ, rays_o, rays_d, *, background_color, capacity: int,
                train=False, randomized=False, generator=None, step=None):
        """Render a batch of rays (N, 3) with unit ``rays_d``; returns the
        reference's outputs (models/nerf.py:110-125). ``randomized`` jitters
        each ray's start with a draw from ``generator`` (the stratified
        march); ``step`` is the training step (a progressive encoding's level
        mask). With ``train`` the result is differentiable with respect to
        ``params`` and adds the packed ``weights``, ``points`` (sample
        midpoints), ``intervals``, ``ray_indices`` and ``sample_valid``;
        without it the forward runs under ``torch.no_grad``."""
        with contextlib.nullcontext() if train else torch.no_grad():
            jitter = None
            if randomized:
                jitter = torch.rand(rays_o.shape[0], generator=generator, device=rays_o.device)
            samples, positions, dirs, t_mid, grp = self.march(occ, rays_o, rays_d, capacity,
                                                              jitter)
            density, feature = self.geometry.apply(params["geometry"], positions, step=step,
                                                   grouped=grp > 1)
            rgb = self.texture.apply(params["texture"], feature, dirs)
            out = self.composite(samples, density, rgb, t_mid, background_color, grp)
        if not train:
            out.pop("weights")
            return out
        out.update({
            "points": t_mid,
            "intervals": samples.t_ends - samples.t_starts,
            "ray_indices": samples.ray_indices,
            "sample_valid": samples.valid,
        })
        return out

    # -- mesh export (reference models/nerf.py:152-161) ---------------------
    def forward_level(self, params, points, step=None):
        return self.geometry.forward_level(params["geometry"], points, step=step)

    def isosurface(self, params, step=None):
        return self.geometry.isosurface(params["geometry"], step=step)

    def vertex_colors(self, params, v_pos, step=None):
        """The radiance at points (N, 3) seen along -z, clipped to [0, 1]."""
        _, feature = self.geometry.apply(params["geometry"], v_pos, step=step)
        viewdirs = torch.zeros_like(v_pos)
        viewdirs[:, 2] = -1.0
        return torch.clamp(self.texture.apply(params["texture"], feature, viewdirs), 0.0, 1.0)

    def export(self, params, export_config, step=None):
        """The mesh (``isosurface``) and, with ``export_vertex_color`` and a
        surface to colour, its :meth:`vertex_colors`, in chunks of
        ``export.chunk_size`` points under ``torch.no_grad``. A failure of
        the colour pass propagates: no geometry-only mesh stands in for it."""
        mesh = self.isosurface(params, step)
        if export_config.get("export_vertex_color", False) and len(mesh["v_pos"]):
            with torch.no_grad():
                mesh["v_rgb"] = chunked_point_eval(
                    lambda v: self.vertex_colors(params, v, step), mesh["v_pos"],
                    export_config.get("chunk_size", 2097152), params_device(params))
        return mesh
