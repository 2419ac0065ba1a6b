"""NeRF system: the smooth-L1 loss and the eval forward.

Port of ``instant_nsr_pl_tpu/systems/nerf.py`` (reference systems/nerf.py:
16-218): the smooth-L1 rgb loss on rays that hit something and were fully
packed, with the training PSNR and live-sample count as metrics. The
MipNeRF-360 distortion loss comes with the NeuS slice, where
``distortion_loss`` is ported (ROADMAP.md section 1, item 3); every shipped
NeRF config sets its weight to 0.
"""

from __future__ import annotations

from instant_nsr_pl_tpu_torch.registry import systems
from instant_nsr_pl_tpu_torch.systems.base import BaseSystem
from instant_nsr_pl_tpu_torch.systems.criterions import psnr, smooth_l1_loss


@systems.register("nerf-system")
class NeRFSystem(BaseSystem):
    def __init__(self, config, device=None):
        super().__init__(config, device)
        loss_cfg = config.system.get("loss", None)
        lambda_dist = loss_cfg.get("lambda_distortion", 0.0) if loss_cfg is not None else 0.0
        if not (isinstance(lambda_dist, (int, float)) and float(lambda_dist) == 0.0):
            raise NotImplementedError(
                "system.loss.lambda_distortion != 0: distortion_loss comes with the NeuS "
                "slice of the port"
            )

    def loss_fn(self, params, occ, batch, generator, step, n_rays=None, capacity=None):
        loss_cfg = self.config.system.loss
        capacity = capacity if capacity is not None else self.train_capacity
        out = self.model.forward(
            params, occ, batch["rays_o"], batch["rays_d"],
            background_color=batch["background_color"], capacity=capacity,
            train=True, randomized=self.randomized, generator=generator,
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
        return loss, metrics

    def forward_eval(self, params, occ, rays_o, rays_d, bg, capacity=None):
        out = self.model.forward(
            params,
            occ,
            rays_o,
            rays_d,
            background_color=bg,
            capacity=capacity or self.eval_capacity,
        )
        return {
            "comp_rgb": out["comp_rgb"],
            "depth": out["depth"],
            "opacity": out["opacity"],
            "rays_kept": out["rays_kept"][:, None],
        }
