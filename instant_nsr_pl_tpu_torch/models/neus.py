"""NeuS SDF renderer with the learned NeRF background.

Port of ``instant_nsr_pl_tpu/models/neus.py:41-506`` (reference
models/neus.py:15-321): the learnable variance with its optional modulation,
the SDF-to-alpha section integral with cosine annealing, the occupancy grid
estimated from the SDF, the foreground march inside the AABB (the packed
march of ``ops/marching.py``, as in ``models/nerf.py``) and compositing of
colour, depth and normals. With ``learned_background`` a second NeRF field
(``geometry_bg`` / ``texture_bg``) renders what lies beyond the AABB: it
marches from the far AABB intersection (from ``near_plane_bg`` on a miss) to
``far_plane_bg`` with cone-angle stepping, through a 256^3 grid in
sphere-contracted space, and the foreground composites over it (``comp_rgb +
comp_rgb_bg * (1 - opacity)``). The training forward is differentiable with
respect to the parameters, through the SDF gradient at second order
(``models/geometry.py`` ``VolumeSDF``); the eval forward runs without
autograd. ``export`` extracts the mesh with "albedo" vertex colours seen
along -normal, the normal from the analytic SDF gradient (JAX
``models/neus.py:451-506``).

Random draws: the JAX package splits its key into a foreground and a
background key; the port draws from one generator in a fixed order, the
foreground march's jitter and then the background's (``forward``), the
foreground grid's update draws and then the background grid's
(``update_occupancy``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.device import resolve_device
from instant_nsr_pl_tpu_torch.models.isosurface import chunked_point_eval
from instant_nsr_pl_tpu_torch.models.nerf import NeRFModel
from instant_nsr_pl_tpu_torch.models.network_utils import params_device
from instant_nsr_pl_tpu_torch.ops.activations import clip
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
    render_weight_from_alpha,
)
from instant_nsr_pl_tpu_torch.registry import models


class VarianceNetwork:
    """One learnable scalar, inv_s = exp(10 * variance), with the optional
    step-scheduled modulation clamp (reference models/neus.py:15-43)."""

    def __init__(self, config):
        self.init_val = float(config.init_val)
        self.modulate = bool(config.get("modulate", False))
        if self.modulate:
            self.mod_start_steps = int(config.mod_start_steps)
            self.reach_max_steps = int(config.reach_max_steps)
            self.max_inv_s = float(config.max_inv_s)

    def init(self, generator=None, device=None):
        return {"variance": torch.tensor(self.init_val, dtype=torch.float32, device=device)}

    def inv_s(self, params, step=None, prev_inv_s=None):
        """exp(10 * variance); with modulation, after ``mod_start_steps`` it
        is capped by the line from the snapshot ``prev_inv_s`` to
        ``max_inv_s`` reached at ``reach_max_steps``."""
        val = torch.exp(params["variance"] * 10.0)
        if self.modulate and step is not None and prev_inv_s is not None:
            ratio = torch.tensor(float(step), dtype=torch.float32) / self.reach_max_steps
            mod_val = torch.minimum(
                ratio.to(val.device) * (self.max_inv_s - prev_inv_s) + prev_inv_s,
                val.new_tensor(self.max_inv_s),
            )
            if step > self.mod_start_steps:
                val = torch.minimum(val, mod_val)
        return val


@models.register("neus")
class NeuSModel:
    def __init__(self, config):
        self.config = config
        self.radius = float(config.radius)
        self.geometry = models.make(config.geometry.name, config.geometry)
        self.texture = models.make(config.texture.name, config.texture)
        self.contraction_type = ContractionType.AABB
        self.geometry.contraction_type = self.contraction_type
        self.variance = VarianceNetwork(config.variance)

        self.num_samples_per_ray = int(config.num_samples_per_ray)
        self.render_step_size = 1.732 * 2.0 * self.radius / self.num_samples_per_ray
        self.grid_prune = bool(config.get("grid_prune", True))
        cell = 2.0 * self.radius / 128
        auto = int(2.0 * cell / self.render_step_size)
        self.occ_stride = int(config.get("grid_lookup_stride", min(8, max(1, auto))))
        while self.num_samples_per_ray % self.occ_stride:
            self.occ_stride -= 1
        self.group_compact = bool(config.get("march_group_compact", True))
        # hash-grid per-group tap dedup (JAX models/neus.py:91-107): the
        # foreground is always AABB with uniform steps, so the march-group
        # guarantee alone gates it; it serves the analytic jac path
        if (bool(config.get("hash_tap_dedup", True)) and self.group_compact
                and self.grid_prune and self.occ_stride > 1):
            self.geometry.configure_dedup(self.occ_stride,
                                          self.render_step_size / (2.0 * self.radius))
        self.occ_thre = float(config.get("grid_prune_occ_thre", 0.01))
        self.occ_spec = OccGridSpec(
            resolution=128, radius=self.radius, contraction_type=self.contraction_type
        )
        self.cos_anneal_end = int(config.get("cos_anneal_end", 0))

        self.learned_background = bool(config.get("learned_background", False))
        if self.learned_background:
            self.geometry_bg = models.make(config.geometry_bg.name, config.geometry_bg)
            self.texture_bg = models.make(config.texture_bg.name, config.texture_bg)
            self.geometry_bg.contraction_type = ContractionType.UN_BOUNDED_SPHERE
            self.near_plane_bg, self.far_plane_bg = 0.1, 1e3
            self.num_samples_per_ray_bg = int(config.num_samples_per_ray_bg)
            self.cone_angle_bg = (
                10.0 ** (math.log10(self.far_plane_bg) / self.num_samples_per_ray_bg) - 1.0)
            self.render_step_size_bg = 0.01
            self.occ_thre_bg = float(config.get("grid_prune_occ_thre_bg", 0.01))
            self.occ_spec_bg = OccGridSpec(
                resolution=256, radius=self.radius,
                contraction_type=ContractionType.UN_BOUNDED_SPHERE)

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

    # -- state -------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None):
        """Parameters drawn from ``generator`` (on the CPU, so a seed gives
        the same weights on every device), placed on ``device``."""
        dev = resolve_device(device)
        params = {
            "geometry": self.geometry.init(generator, dev),
            "texture": self.texture.init(generator, dev),
            "variance": self.variance.init(generator, dev),
        }
        if self.learned_background:
            params["geometry_bg"] = self.geometry_bg.init(generator, dev)
            params["texture_bg"] = self.texture_bg.init(generator, dev)
        return params

    def init_occupancy(self, device=None):
        occ = {"grid": occupancy_grid_init(self.occ_spec, device)}
        if self.learned_background:
            occ["grid_bg"] = occupancy_grid_init(self.occ_spec_bg, device)
        return occ

    def init_extra_state(self, device=None):
        """Non-gradient training state beyond the grid: the pre-modulation
        inv_s snapshot of the modulation clamp (reference models/neus.py:
        30-43)."""
        if self.variance.modulate:
            val = torch.exp(torch.tensor(self.variance.init_val, dtype=torch.float32) * 10.0)
            return {"prev_inv_s": val.to(resolve_device(device))}
        return {}

    def update_extra_state(self, params, extra, step):
        """Snapshot inv_s until modulation starts."""
        if not self.variance.modulate or step > self.variance.mod_start_steps:
            return extra
        with torch.no_grad():
            return {**extra, "prev_inv_s": torch.exp(params["variance"]["variance"] * 10.0)}

    def cos_anneal_ratio(self, step):
        """Grows 0 -> 1 over cos_anneal_end steps (reference models/neus.py:92),
        a float32 value."""
        if self.cos_anneal_end == 0 or step is None:
            return 1.0
        return float(min(np.float32(1.0), np.float32(step) / np.float32(self.cos_anneal_end)))

    # -- occupancy maintenance (reference models/neus.py:94-111) -----------
    def update_occupancy(self, params, occ, generator, warmup=False, phase=None, step=None,
                         group=None):
        """One grid update with the occupancy estimated from the SDF at
        training step ``step``: the alpha of a step-sized section at the
        cell's point, without the view term (``geometry.apply`` without
        gradient: the plain encode, K5 or HG1 on the card, in chunks of 2^18
        points). With the learned background, then the background grid's
        update with density * its base step (HG1 on the card)."""
        if not self.grid_prune:
            return occ
        inv_s = clip(self.variance.inv_s(params["variance"]), 1e-6, 1e6)
        half = self.render_step_size * 0.5

        def occ_eval(x):
            sdf = self.geometry.apply(params["geometry"], x, step=step, with_grad=False,
                                      with_feature=False)
            prev_cdf = torch.sigmoid((sdf + half) * inv_s)
            next_cdf = torch.sigmoid((sdf - half) * inv_s)
            return clip((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)

        def occ_eval_fn(x):
            return torch.cat([occ_eval(c) for c in x.split(1 << 18)])

        new = {"grid": occupancy_grid_update(
            occ["grid"], self.occ_spec, occ_eval_fn, generator,
            occ_thre=self.occ_thre, warmup=warmup, phase=phase, group=group,
        )}
        if self.learned_background:
            def occ_eval_fn_bg(x):
                density = [self.geometry_bg.apply(params["geometry_bg"], c, step=step)[0]
                           for c in x.split(1 << 18)]
                return torch.cat(density) * self.render_step_size_bg

            new["grid_bg"] = occupancy_grid_update(
                occ["grid_bg"], self.occ_spec_bg, occ_eval_fn_bg, generator,
                occ_thre=self.occ_thre_bg, warmup=warmup, phase=phase, group=group,
            )
        return new

    # -- NeuS alpha (reference models/neus.py:117-139) ----------------------
    def get_alpha(self, inv_s, cos_anneal_ratio, sdf, normal, dirs, dists):
        true_cos = (dirs * normal).sum(-1)
        # the anneal keeps the cos "not dead" early in training
        iter_cos = -(
            torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
            + torch.relu(-true_cos) * cos_anneal_ratio
        )  # never positive
        est_next_sdf = sdf + iter_cos * dists * 0.5
        est_prev_sdf = sdf - iter_cos * dists * 0.5
        prev_cdf = torch.sigmoid(est_prev_sdf * inv_s)
        next_cdf = torch.sigmoid(est_next_sdf * inv_s)
        return clip((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)

    # -- rendering ---------------------------------------------------------
    def march(self, occ, rays_o, rays_d, capacity: int, jitter=None):
        """Slab test, occupancy-pruned march and sample positions:
        (samples, positions, dirs, t_mid, dists, group)."""
        t_min, t_max = ray_aabb_intersect(rays_o, rays_d, -self.radius, self.radius)
        grp = self.packed_group(capacity)
        grid = occ["grid"]
        samples = march_rays(
            rays_o, rays_d, t_min, t_max,
            render_step_size=self.render_step_size,
            max_samples=self.num_samples_per_ray,
            capacity=capacity,
            occ_binary=grid.binary if self.grid_prune else None,
            occ_spec=self.occ_spec,
            occ_dilated=grid.binary_dilated if self.grid_prune else None,
            occ_stride=self.occ_stride,
            group_compact=grp > 1,
            jitter=jitter,
        )
        positions, dirs, t_mid, dists = packed_positions(samples, rays_o, rays_d, group=grp)
        return samples, positions, dirs, t_mid, dists, grp

    def forward_bg(self, params, occ, rays_o, rays_d, *, background_color, capacity: int,
                   train=False, jitter=None, step=0):
        """The background field (reference models/neus.py:141-203): a NeRF
        march from the far AABB intersection (``near_plane_bg`` where the ray
        misses the AABB) to ``far_plane_bg`` with cone-angle stepping through
        the background grid, one probe per sample, composited onto
        ``background_color``. ``jitter``: the (R,) draws of a stratified
        march. Called inside :meth:`forward`'s autograd mode."""
        _, t_max = ray_aabb_intersect(rays_o, rays_d, -self.radius, self.radius)
        near = torch.where(t_max > 1e9, torch.full_like(t_max, self.near_plane_bg), t_max)
        far = torch.full_like(t_max, self.far_plane_bg)
        grid = occ["grid_bg"]
        samples = march_rays(
            rays_o, rays_d, near, far,
            render_step_size=self.render_step_size_bg,
            max_samples=self.num_samples_per_ray_bg,
            capacity=capacity,
            occ_binary=grid.binary if self.grid_prune else None,
            occ_spec=self.occ_spec_bg,
            jitter=jitter,
            cone_angle=self.cone_angle_bg,
        )
        positions, dirs, t_mid, intervals = packed_positions(samples, rays_o, rays_d)
        density, feature = self.geometry_bg.apply(params["geometry_bg"], positions, step=step)
        rgb = self.texture_bg.apply(params["texture_bg"], feature, dirs)
        out = NeRFModel.composite(samples, density, rgb, t_mid, background_color, 1)
        if not train:
            del out["weights"]
            return out
        out.update({
            "points": t_mid,
            "intervals": intervals,
            "ray_indices": samples.ray_indices,
            "sample_valid": samples.valid,
        })
        return out

    def forward(self, params, occ, rays_o, rays_d, *, background_color, capacity: int,
                capacity_bg=None, train=False, randomized=False, generator=None, step=0,
                prev_inv_s=None):
        """Render a batch of rays (N, 3) with unit ``rays_d``; returns the JAX
        package's outputs (``comp_rgb``, ``comp_normal``, ``opacity``,
        ``depth``, ``inv_s`` ...; ``*_full`` composited onto the background
        colour). With ``train`` the result is differentiable with respect to
        ``params`` and adds the per-sample ``sdf_samples``,
        ``sdf_grad_samples`` (and ``sdf_laplace_samples`` with finite
        differences), ``weights``, ``points``, ``intervals``, ``ray_indices``
        and ``sample_valid``; without it the forward runs under
        ``torch.no_grad``. With the learned background the background
        field's outputs come as ``*_bg`` (marched into ``capacity_bg``
        samples, ``capacity`` when None) and the foreground composites over
        its colour."""
        geo = self.geometry
        with contextlib.nullcontext() if train else torch.no_grad():
            jitter = jitter_bg = None
            if randomized:
                jitter = torch.rand(rays_o.shape[0], generator=generator, device=rays_o.device)
                if self.learned_background:
                    jitter_bg = torch.rand(rays_o.shape[0], generator=generator,
                                           device=rays_o.device)
            samples, positions, dirs, t_mid, dists, grp = self.march(
                occ, rays_o, rays_d, capacity, jitter)
            sdf_laplace = None
            if geo.grad_type == "finite_difference":
                sdf, sdf_grad, feature, sdf_laplace = geo.apply(
                    params["geometry"], positions, step=step, with_grad=True,
                    with_feature=True, with_laplace=True)
            else:
                sdf, sdf_grad, feature = geo.apply(
                    params["geometry"], positions, step=step, with_grad=True,
                    with_feature=True, grouped=grp > 1)
            # an EXACTLY zero gradient (padding samples with collapsed clipped
            # stencils) makes the norm's backward NaN even where masked:
            # substitute a safe unit vector
            grad_norm2 = (sdf_grad * sdf_grad).sum(-1, keepdim=True)
            sdf_grad = torch.where(
                (grad_norm2 > 1e-20) & samples.valid[:, None],
                sdf_grad,
                sdf_grad.new_tensor(1.0 / math.sqrt(3.0)),
            )
            normal = sdf_grad / torch.maximum(
                torch.linalg.norm(sdf_grad, dim=-1, keepdim=True), sdf_grad.new_tensor(1e-10))
            inv_s = clip(self.variance.inv_s(params["variance"], step=step,
                                             prev_inv_s=prev_inv_s), 1e-6, 1e6)
            alpha = self.get_alpha(inv_s, self.cos_anneal_ratio(step), sdf, normal, dirs, dists)
            rgb = self.texture.apply(params["texture"], feature, dirs, normal)
            weights = render_weight_from_alpha(alpha, samples.ray_indices, samples.valid,
                                               group=grp)
            vals = torch.cat([torch.ones_like(t_mid)[:, None], t_mid[:, None], rgb, normal],
                             dim=-1)
            acc = accumulate_along_rays(weights, vals, samples.ray_ends, valid=samples.valid,
                                        group=grp)
            opacity, depth = acc[:, 0:1], acc[:, 1:2]
            comp_rgb, comp_normal = acc[:, 2:5], acc[:, 5:8]
            comp_normal = comp_normal / torch.maximum(
                torch.linalg.norm(comp_normal, dim=-1, keepdim=True),
                comp_normal.new_tensor(1e-10))
            out = {
                "comp_rgb": comp_rgb,
                "comp_normal": comp_normal,
                "opacity": opacity,
                "depth": depth,
                "rays_valid": opacity > 0,
                "rays_kept": samples.ray_kept,
                "num_samples": samples.num_valid,
                "inv_s": inv_s,
            }
            if self.learned_background:
                out_bg = self.forward_bg(
                    params, occ, rays_o, rays_d, background_color=background_color,
                    capacity=capacity_bg or capacity, train=train, jitter=jitter_bg, step=step)
                out.update({k + "_bg": v for k, v in out_bg.items()})
                out.update({
                    "comp_rgb_full": comp_rgb + out_bg["comp_rgb"] * (1.0 - opacity),
                    "num_samples_full": samples.num_valid + out_bg["num_samples"],
                    "rays_valid_full": out["rays_valid"] | out_bg["rays_valid"],
                    "rays_kept_full": samples.ray_kept & out_bg["rays_kept"],
                })
            else:
                # no learned background: the background is the colour itself
                bg = torch.as_tensor(background_color, dtype=comp_rgb.dtype,
                                     device=comp_rgb.device).expand_as(comp_rgb)
                out.update({
                    "comp_rgb_bg": bg,
                    "comp_rgb_full": comp_rgb + bg * (1.0 - opacity),
                    "num_samples_full": samples.num_valid,
                    "rays_valid_full": opacity > 0,
                    "rays_kept_full": samples.ray_kept,
                })
            if train:
                out.update({
                    "sdf_samples": sdf,
                    "sdf_grad_samples": sdf_grad,
                    "weights": weights,
                    "points": t_mid,
                    "intervals": dists,
                    "ray_indices": samples.ray_indices,
                    "sample_valid": samples.valid,
                })
                if sdf_laplace is not None:
                    out["sdf_laplace_samples"] = sdf_laplace
        return out

    # -- mesh export (reference models/neus.py:316-321) ---------------------
    def forward_level(self, params, points, step=None):
        return self.geometry.forward_level(params["geometry"], points, step=step)

    def isosurface(self, params, step=None):
        return self.geometry.isosurface(params["geometry"], step=step)

    def vertex_colors(self, params, v_pos, step=None):
        """The "albedo" colour at points (N, 3): the radiance seen along
        -normal, the normal from the analytic SDF gradient (on the jac path,
        K7, K9 or HG3 in eval mode on the card), clipped to [0, 1]."""
        _, sdf_grad, feature = self.geometry.apply(params["geometry"], v_pos, step=step,
                                                   with_grad=True, with_feature=True)
        normal = sdf_grad / torch.clamp(torch.linalg.norm(sdf_grad, dim=-1, keepdim=True),
                                        min=1e-10)
        rgb = self.texture.apply(params["texture"], feature, -normal, normal)
        return torch.clamp(rgb, 0.0, 1.0)

    def export(self, params, export_config, step=None):
        """The mesh (``isosurface``) at training step ``step`` and, with
        ``export_vertex_color`` and a surface to colour, its
        :meth:`vertex_colors`, in chunks of ``export.chunk_size`` points
        capped at 262,144 under ``torch.no_grad``. A failure of the colour
        pass propagates: no geometry-only mesh stands in for it."""
        mesh = self.isosurface(params, step)
        if export_config.get("export_vertex_color", False) and len(mesh["v_pos"]):
            chunk = min(int(export_config.get("chunk_size", 2097152)), 262144)
            with torch.no_grad():
                mesh["v_rgb"] = chunked_point_eval(lambda v: self.vertex_colors(params, v, step),
                                                   mesh["v_pos"], chunk, params_device(params))
        return mesh
