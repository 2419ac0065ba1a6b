"""NeuS training system.

Port of ``instant_nsr_pl_tpu/systems/neus.py:31-191`` (reference
systems/neus.py:17-265): rgb MSE and L1 on the composite, the eikonal loss on
the SDF gradients, mask BCE, opaque BCE, sparsity, curvature (the
finite-difference Laplacian) and the foreground distortion loss, every weight
a ``C()``-scheduled scalar. Sample-level means are masked by the packed
validity mask (the reference's ragged buffers hold only live samples; the
packed buffer carries padding). ``image_grid_specs`` gives the panels of a
saved view. The background distortion loss comes with the learned background.
"""

from __future__ import annotations

import torch

from instant_nsr_pl_tpu_torch.ops.activations import clip
from instant_nsr_pl_tpu_torch.ops.rendering import distortion_loss
from instant_nsr_pl_tpu_torch.registry import systems
from instant_nsr_pl_tpu_torch.systems.base import BaseSystem, is_zero
from instant_nsr_pl_tpu_torch.systems.criterions import (
    binary_cross_entropy,
    l1_loss,
    mse_loss,
    psnr,
)


def _masked_mean(x, mask):
    m = mask.float()
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


@systems.register("neus-system")
class NeuSSystem(BaseSystem):
    def __init__(self, config, device=None):
        super().__init__(config, device)
        loss_cfg = config.system.get("loss", None) or {}
        if not is_zero(loss_cfg.get("lambda_distortion_bg", 0.0)):
            raise NotImplementedError(
                "system.loss.lambda_distortion_bg != 0: the background distortion loss "
                "comes with the learned background, in the unbounded-scene slice of the "
                "port (ROADMAP.md queue item 6)"
            )

    def loss_fn(self, params, occ, batch, generator, step, n_rays=None, capacity=None,
                extra=None):
        cfg = self.config.system.loss
        n_rays = n_rays if n_rays is not None else self.train_num_rays
        capacity = capacity if capacity is not None else self.train_capacity
        out = self.model.forward(
            params, occ, batch["rays_o"], batch["rays_d"],
            background_color=batch["background_color"], capacity=capacity,
            train=True, randomized=self.randomized, generator=generator, step=step,
            prev_inv_s=(extra or {}).get("prev_inv_s"),
        )
        ray_mask = (out["rays_valid_full"][:, 0] & out["rays_kept_full"]).float()[:, None]
        sample_mask = out["sample_valid"]
        denom = torch.clamp(ray_mask.sum() * 3.0, min=1.0)
        metrics = {}

        # rgb (reference systems/neus.py:98-104)
        loss_rgb_mse = mse_loss(out["comp_rgb_full"], batch["rgb"], weight=ray_mask,
                                reduction="sum") / denom
        metrics["train/loss_rgb_mse"] = loss_rgb_mse.detach()
        loss = loss_rgb_mse * self.C(cfg.lambda_rgb_mse, step)
        loss_rgb_l1 = l1_loss(out["comp_rgb_full"], batch["rgb"], weight=ray_mask,
                              reduction="sum") / denom
        metrics["train/loss_rgb_l1"] = loss_rgb_l1.detach()
        loss = loss + loss_rgb_l1 * self.C(cfg.get("lambda_rgb_l1", 0.0), step)

        # eikonal (reference systems/neus.py:106-108)
        grad_norm = torch.linalg.norm(out["sdf_grad_samples"], dim=-1)
        loss_eikonal = _masked_mean((grad_norm - 1.0) ** 2, sample_mask)
        metrics["train/loss_eikonal"] = loss_eikonal.detach()
        loss = loss + loss_eikonal * self.C(cfg.lambda_eikonal, step)

        # mask BCE (reference systems/neus.py:110-113)
        opacity = clip(out["opacity"][:, 0], 1e-3, 1.0 - 1e-3)
        if self.has_mask and not is_zero(cfg.get("lambda_mask", 0.0)):
            fg = batch["fg_mask"]
            keep = out["rays_kept"].float()
            bce = -(fg * torch.log(opacity) + (1.0 - fg) * torch.log(1.0 - opacity))
            loss_mask = (bce * keep).sum() / torch.clamp(keep.sum(), min=1.0)
            metrics["train/loss_mask"] = loss_mask.detach()
            loss = loss + loss_mask * self.C(cfg.lambda_mask, step)

        # opaque BCE(o, o) (reference systems/neus.py:115-117)
        if not is_zero(cfg.get("lambda_opaque", 0.0)):
            loss_opaque = binary_cross_entropy(opacity, opacity)
            metrics["train/loss_opaque"] = loss_opaque.detach()
            loss = loss + loss_opaque * self.C(cfg.lambda_opaque, step)

        # sparsity (reference systems/neus.py:119-121)
        if not is_zero(cfg.get("lambda_sparsity", 0.0)):
            scale = float(cfg.get("sparsity_scale", 1.0))
            loss_sparsity = _masked_mean(torch.exp(-scale * out["sdf_samples"].abs()),
                                         sample_mask)
            metrics["train/loss_sparsity"] = loss_sparsity.detach()
            loss = loss + loss_sparsity * self.C(cfg.lambda_sparsity, step)

        # curvature via the finite-difference Laplacian (reference
        # systems/neus.py:123-127)
        if not is_zero(cfg.get("lambda_curvature", 0.0)):
            if "sdf_laplace_samples" not in out:
                raise ValueError("the curvature loss requires geometry.grad_type: "
                                 "finite_difference")
            loss_curvature = _masked_mean(out["sdf_laplace_samples"].abs(), sample_mask)
            metrics["train/loss_curvature"] = loss_curvature.detach()
            loss = loss + loss_curvature * self.C(cfg.lambda_curvature, step)

        # foreground distortion (reference systems/neus.py:129-134)
        if not is_zero(cfg.get("lambda_distortion", 0.0)):
            loss_dist = distortion_loss(
                out["weights"], out["points"], out["intervals"], out["ray_indices"],
                out["sample_valid"], n_rays=n_rays, group=self.model.packed_group(capacity))
            metrics["train/loss_distortion"] = loss_dist.detach()
            loss = loss + loss_dist * self.C(cfg.lambda_distortion, step)

        metrics["train/inv_s"] = out["inv_s"].detach()
        metrics["train/num_samples"] = out["num_samples_full"]
        metrics["train/psnr"] = psnr(out["comp_rgb_full"].detach(), batch["rgb"],
                                     valid_mask=ray_mask > 0)
        return loss, metrics

    def forward_eval(self, params, occ, rays_o, rays_d, bg, step=0, capacity=None):
        out = self.model.forward(
            params, occ, rays_o, rays_d, background_color=bg,
            capacity=capacity or self.eval_capacity, step=step,
        )
        return {
            "comp_rgb": out["comp_rgb_full"],
            "comp_normal": out["comp_normal"],
            "depth": out["depth"],
            "opacity": out["opacity"],
            "rays_kept": out["rays_kept_full"][:, None],
        }

    def image_grid_specs(self, res):
        """Panels of a saved view: gt | rgb | depth (jet) | normal (reference
        systems/neus.py:171-186, without the learned background's panels)."""
        imgs = res["images"]
        return [
            {"type": "rgb", "img": res["gt"]},
            {"type": "rgb", "img": imgs["comp_rgb"]},
            {"type": "grayscale", "img": imgs["depth"], "kwargs": {"cmap": "jet"}},
            {"type": "normal", "img": imgs["comp_normal"]},
        ]
