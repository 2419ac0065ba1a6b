"""NeRF system: the smooth-L1 loss, the distortion loss and the eval forward.

Port of ``instant_nsr_pl_tpu/systems/nerf.py`` (reference systems/nerf.py:
16-218): the smooth-L1 rgb loss on rays that hit something and were fully
packed, the optional MipNeRF-360 distortion loss, with the training PSNR and
live-sample count as metrics, and the panels of a saved view.
"""

from __future__ import annotations

from instant_nsr_pl_tpu_torch.ops.rendering import distortion_loss
from instant_nsr_pl_tpu_torch.registry import systems
from instant_nsr_pl_tpu_torch.systems.base import BaseSystem, is_zero
from instant_nsr_pl_tpu_torch.systems.criterions import psnr, smooth_l1_loss


@systems.register("nerf-system")
class NeRFSystem(BaseSystem):
    def loss_fn(self, params, occ, batch, generator, step, n_rays=None, capacity=None,
                extra=None):
        loss_cfg = self.config.system.loss
        n_rays = n_rays if n_rays is not None else self.train_num_rays
        capacity = capacity if capacity is not None else self.train_capacity
        out = self.model.forward(
            params, occ, batch["rays_o"], batch["rays_d"],
            background_color=batch["background_color"], capacity=capacity,
            train=True, randomized=self.randomized, generator=generator, step=step,
        )
        # loss only on rays that hit something AND were fully packed
        mask = (out["rays_valid"][:, 0] & out["rays_kept"]).float()
        denom = mask.sum().clamp(min=1.0)
        per_ray = smooth_l1_loss(out["comp_rgb"], batch["rgb"], reduction="none").mean(-1)
        loss_rgb = (per_ray * mask).sum() / denom
        loss = loss_rgb * self.C(loss_cfg.lambda_rgb, step)
        metrics = {
            "train/loss_rgb": loss_rgb.detach(),
            "train/num_samples": out["num_samples"],
            "train/psnr": psnr(out["comp_rgb"].detach(), batch["rgb"],
                               valid_mask=mask[:, None] > 0),
        }
        lambda_dist = loss_cfg.get("lambda_distortion", 0.0)
        if not is_zero(lambda_dist):
            loss_dist = distortion_loss(
                out["weights"], out["points"], out["intervals"], out["ray_indices"],
                out["sample_valid"], n_rays=n_rays, group=self.model.packed_group(capacity))
            metrics["train/loss_distortion"] = loss_dist.detach()
            loss = loss + loss_dist * self.C(lambda_dist, step)
        return loss, metrics

    def forward_eval(self, params, occ, rays_o, rays_d, bg, step=0, capacity=None):
        out = self.model.forward(
            params,
            occ,
            rays_o,
            rays_d,
            background_color=bg,
            capacity=capacity or self.eval_capacity,
            step=step,
        )
        return {
            "comp_rgb": out["comp_rgb"],
            "depth": out["depth"],
            "opacity": out["opacity"],
            "rays_kept": out["rays_kept"][:, None],
        }

    def image_grid_specs(self, res):
        """Panels of a saved view: gt | rgb | depth (jet) | opacity
        (reference systems/nerf.py:140-145)."""
        imgs = res["images"]
        return [
            {"type": "rgb", "img": res["gt"]},
            {"type": "rgb", "img": imgs["comp_rgb"]},
            {"type": "grayscale", "img": imgs["depth"], "kwargs": {"cmap": "jet"}},
            {"type": "grayscale", "img": imgs["opacity"],
             "kwargs": {"cmap": None, "data_range": (0, 1)}},
        ]
