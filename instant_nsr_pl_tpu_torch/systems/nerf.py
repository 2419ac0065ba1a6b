"""NeRF system, render side.

Port of ``instant_nsr_pl_tpu/systems/nerf.py`` ``NeRFSystem.forward_eval``
(:75-93). The loss and the train step belong to the training slice.
"""

from __future__ import annotations

from instant_nsr_pl_tpu_torch.registry import systems
from instant_nsr_pl_tpu_torch.systems.base import BaseSystem


@systems.register("nerf-system")
class NeRFSystem(BaseSystem):
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
