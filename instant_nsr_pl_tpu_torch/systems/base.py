"""Base system, render side: dataset arrays on the device, chunked image
rendering with overflow retries, and image metrics.

Port of ``instant_nsr_pl_tpu/systems/base.py`` (``setup_data``,
``render_image`` :546-681, ``evaluate_image`` :683-706). The JAX package jits
one render chunk; the port runs it eagerly. The train state, sampling,
optimizer and train step belong to the training slice.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.device import resolve_device
from instant_nsr_pl_tpu_torch.ops.ray import get_rays
from instant_nsr_pl_tpu_torch.registry import models
from instant_nsr_pl_tpu_torch.systems.criterions import psnr, ssim


def pixels_to_f32(x):
    """Dequantize uint8 pixels to float32 in [0, 1]; float data passes."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def dataset_device_arrays(dataset, device):
    """A dataset split's numpy arrays as tensors on ``device``; with
    ``load_data_on_gpu: false`` pixels stay uint8 (a quarter of the memory)."""
    on_gpu = bool(getattr(dataset, "config", {}).get("load_data_on_gpu", True))
    images = np.asarray(dataset.all_images, np.float32)
    masks = np.asarray(dataset.all_fg_masks, np.float32)
    if not on_gpu:
        images = np.round(np.clip(images, 0.0, 1.0) * 255.0).astype(np.uint8)
        masks = np.round(np.clip(masks, 0.0, 1.0) * 255.0).astype(np.uint8)
    return {
        "images": torch.as_tensor(images, device=device),
        "fg_masks": torch.as_tensor(masks, device=device),
        "c2w": torch.as_tensor(np.asarray(dataset.all_c2w, np.float32), device=device),
        "directions": torch.as_tensor(np.asarray(dataset.directions, np.float32), device=device),
    }


class BaseSystem:
    """Holds the model and the dataset arrays on ``device`` (CUDA unless the
    caller passes another) and renders images in fixed-size ray chunks.
    Subclasses implement ``forward_eval``."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = models.make(config.model.name, config.model)
        m = config.model
        # reference configs spell the eval chunk `ray_chunk`
        self.eval_chunk_rays = int(m.get("eval_chunk_rays", m.get("ray_chunk", 4096)))
        self.eval_capacity = int(m.get("eval_num_samples", self.eval_chunk_rays * 128))
        self.data = None  # set by setup_data
        self._eval_capacity_scale = 1
        self.last_render_stats = None

    # -- data ---------------------------------------------------------------
    def setup_data(self, dataset):
        """Move a split's arrays (all_images (N,H,W,3), all_fg_masks (N,H,W),
        all_c2w (N,3,4), directions (H,W,3) or (N,H,W,3)) onto the device."""
        self.data = dataset_device_arrays(dataset, self.device)
        self.w = int(dataset.w)
        self.h = int(dataset.h)
        self.n_images = int(self.data["images"].shape[0])
        self.has_mask = bool(getattr(dataset, "has_mask", False))
        self.apply_mask = bool(getattr(dataset, "apply_mask", False))

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Render state ``{params, occ}`` with parameters drawn from a
        CPU ``torch.Generator`` seeded with ``seed``."""
        generator = torch.Generator().manual_seed(seed)
        return {
            "params": self.model.init(generator, self.device),
            "occ": self.model.init_occupancy(self.device),
        }

    # -- evaluation ---------------------------------------------------------
    def forward_eval(self, params, occ, rays_o, rays_d, bg, capacity=None):
        raise NotImplementedError

    def render_chunk(self, state, rays_o, rays_d, capacity_scale: int = 1):
        """One fixed-size chunk on a white background (the JAX package's
        jitted ``make_render_chunk``)."""
        bg = torch.ones(3, dtype=torch.float32, device=rays_o.device)
        return self.forward_eval(
            state["params"], state["occ"], rays_o, rays_d, bg,
            capacity=self.eval_capacity * capacity_scale,
        )

    def render_image(self, state, index: int, data=None):
        """Render a full image by fixed-size chunks; returns a dict of
        (H, W, C) numpy arrays (reference ``chunk_batch``,
        models/utils.py:13-50). Rays whose live samples overflowed the eval
        capacity are rendered again in halving groups, then at a doubled
        capacity, so every pixel is complete."""
        data = data if data is not None else self.data
        h, w = int(data["images"].shape[1]), int(data["images"].shape[2])
        if data["directions"].ndim == 3:
            dirs_cam = data["directions"].reshape(-1, 3)
        else:
            dirs_cam = data["directions"][index].reshape(-1, 3)
        rays_o, rays_d = get_rays(dirs_cam, data["c2w"][index])
        rays_d = rays_d / torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-10)
        n = rays_o.shape[0]
        chunk = self.eval_chunk_rays

        # padding rays must consume ZERO packed capacity: aim them away from
        # the scene AABB so the slab test yields an empty interval
        radius = float(getattr(self.model, "radius", 1.0))
        pad_o = torch.tensor([2.0 * radius + 10.0, 0.0, 0.0], device=rays_o.device)
        pad_d = torch.tensor([1.0, 0.0, 0.0], device=rays_o.device)

        def render_chunk_np(ro, rd, scale):
            n_real = ro.shape[0]
            if n_real < chunk:  # pad to the fixed chunk size
                pad = chunk - n_real
                ro = torch.cat([ro, pad_o.expand(pad, 3)])
                rd = torch.cat([rd, pad_d.expand(pad, 3)])
            out = self.render_chunk(state, ro, rd, scale)
            return {k: v[:n_real].cpu().numpy() for k, v in out.items()}

        t0 = time.time()
        scale = self._eval_capacity_scale
        outs = [
            render_chunk_np(rays_o[s:s + chunk], rays_d[s:s + chunk], scale)
            for s in range(0, n, chunk)
        ]
        merged = {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}

        first_pass_overflow = int((~merged["rays_kept"][:, 0].astype(bool)).sum())
        group_size, prev_bad = max(chunk // 2, 1), None
        while True:
            bad = np.nonzero(~merged["rays_kept"][:, 0].astype(bool))[0]
            if len(bad) == 0:
                break
            print(
                f"[render] view {index}: retry pass, {len(bad)} overflowed rays, "
                f"group={group_size}, capacity x{scale} ({time.time() - t0:.0f}s)",
                flush=True, file=sys.stderr,
            )
            if group_size == 1 and prev_bad is not None and len(bad) >= prev_bad:
                scale *= 2
                prev_bad = None
                group_size = max(chunk // 2, 1)  # doubled capacity: regroup
                if scale > 8:
                    raise RuntimeError(
                        f"render_image: {len(bad)}/{n} rays exceed "
                        f"{self.eval_capacity * 8} samples even rendered alone at "
                        "8x the configured eval capacity; raise model.eval_num_samples"
                    )
            else:
                prev_bad = len(bad)
            bad_t = torch.as_tensor(bad, device=rays_o.device)
            for b in range(0, len(bad), group_size):
                group = bad[b:b + group_size]
                idx = bad_t[b:b + group_size]
                retry = render_chunk_np(rays_o[idx], rays_d[idx], scale)
                kept_now = retry["rays_kept"][:, 0].astype(bool)
                for k in merged:
                    merged[k][group[kept_now]] = retry[k][kept_now]
            group_size = max(group_size // 2, 1)
        # later views start at the scale that worked
        self._eval_capacity_scale = scale
        kept = merged.pop("rays_kept")
        self.last_render_stats = {
            "rays": n,
            "rays_kept": int(kept.astype(bool).sum()),
            "first_pass_overflow": first_pass_overflow,
            "capacity_scale": scale,
        }
        return {k: v.reshape(h, w, -1) for k, v in merged.items()}

    def evaluate_image(self, state, index: int, data=None):
        """Render one view and compute PSNR + SSIM against the ground truth
        (reference validation_step, systems/nerf.py:136-148). Eval renders on
        white, so masked ground truth is composited onto white too."""
        data = data if data is not None else self.data
        images = self.render_image(state, index, data=data)
        gt = pixels_to_f32(data["images"][index])
        if self.apply_mask:
            mask = pixels_to_f32(data["fg_masks"][index])[..., None]
            gt = gt * mask + (1.0 - mask)
        pred = torch.as_tensor(images["comp_rgb"], device=gt.device)
        return {
            "psnr": float(psnr(pred, gt)),
            "ssim": float(ssim(pred, gt)),
            "images": images,
            "gt": gt.cpu().numpy(),
        }
