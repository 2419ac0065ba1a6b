"""Base system: dataset arrays on the device, the train state and step, and
chunked image rendering with overflow retries and image metrics.

Port of ``instant_nsr_pl_tpu/systems/base.py`` (the train side :28-474,
``render_image`` :546-681, ``evaluate_image`` :683-706). The JAX package
jits a pure step over an immutable state pytree; the port runs eagerly and
its state is a dict whose parameters the optimizer updates in place
(``extra``: the model's non-gradient state, e.g. NeuS's inv_s snapshot):

    state = {params, optimizer, occ, extra, step, generator}

``generator`` is a ``torch.Generator`` on the state's device, seeded from
``init_state(seed)``; it draws every random number of training (rays,
pixels, background, march jitter, grid updates). Parameters are drawn from
a CPU generator with the same seed, so a seed gives the same weights on
every device.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.device import resolve_device
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable
from instant_nsr_pl_tpu_torch.ops.ray import get_rays
from instant_nsr_pl_tpu_torch.registry import models
from instant_nsr_pl_tpu_torch.systems.criterions import psnr, ssim
from instant_nsr_pl_tpu_torch.systems.optimizers import make_optimizer


def C(value, step, epoch_steps=None):
    """Scheduled scalar (reference ``BaseSystem.C``, systems/base.py:28-45):
    a number, or [start_step, start_value, end_value, end_step] (or the
    3-element form with start_step 0) interpolated linearly by step. A float
    end_step interpolates by the integer epoch ``floor(step / epoch_steps)``,
    one nominal epoch being one pass over the train split's images."""
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    if len(value) != 4:
        raise ValueError(f"bad scheduled value spec {value}")
    start_step, start_value, end_value, end_step = value
    if isinstance(end_step, int):
        cur = float(step)
        denom = max(end_step - start_step, 1)
    else:
        if not epoch_steps:
            raise ValueError(
                f"scheduled value {value}: a float end_step selects the epoch-based "
                "interpolation; this system has no dataset length to translate "
                "epochs to steps (call setup_data first, or use integer steps)"
            )
        cur = float(step // epoch_steps)
        denom = max(float(end_step) - float(start_step), 1e-9)
    t = min(max((cur - float(start_step)) / denom, 0.0), 1.0)
    return float(start_value) + t * (float(end_value) - float(start_value))


def is_zero(value):
    """True for a loss weight that is the number 0 (a schedule never is)."""
    return isinstance(value, (int, float)) and float(value) == 0.0


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
    caller passes another), trains with :meth:`train_step` and renders
    images in fixed-size ray chunks. Subclasses implement ``loss_fn`` and
    ``forward_eval``."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = models.make(config.model.name, config.model)
        m = config.model
        # the static batch: max_train_num_rays rays, train_num_samples packed
        # samples (the reference's train_num_rays * num_samples_per_ray)
        self.train_num_rays = int(m.get("max_train_num_rays", m.get("train_num_rays", 8192)))
        self.train_capacity = int(m.get(
            "train_num_samples", int(m.get("train_num_rays", 256)) * int(m.num_samples_per_ray)))
        # reference configs spell the eval chunk `ray_chunk`
        self.eval_chunk_rays = int(m.get("eval_chunk_rays", m.get("ray_chunk", 4096)))
        self.eval_capacity = int(m.get("eval_num_samples", self.eval_chunk_rays * 128))
        self.background_color_mode = str(m.get("background_color", "random"))
        self.batch_image_sampling = bool(m.get("batch_image_sampling", True))
        self.randomized = bool(m.get("randomized", True))
        self.grid_warmup_steps = int(m.get("grid_warmup_steps", 256))
        self.grid_update_every = int(m.get("grid_update_every", 16))
        # 'slab': the rotating contiguous-slab refresh; 'random': uniform plus
        # occupied cells (ops/marching.py occupancy_grid_update)
        self.grid_update_sampling = str(m.get("grid_update_sampling", "slab"))
        # bucketed dynamic ray batching (reference systems/nerf.py:93-95): a
        # power-of-two ladder up to max_train_num_rays, switched from the
        # live-sample count at log cadence
        self.dynamic_ray_sampling = bool(m.get("dynamic_ray_sampling", True))
        start = int(m.get("train_num_rays", max(self.train_num_rays // 8, 64)))
        ladder = []
        r = max(start, 64)
        while r < self.train_num_rays:
            ladder.append(r)
            r *= 2
        ladder.append(self.train_num_rays)
        self.ray_buckets = ladder
        self.active_num_rays = ladder[0] if self.dynamic_ray_sampling else self.train_num_rays
        self.data = None  # set by setup_data
        self.steps_per_epoch = None
        self._eval_capacity_scale = 1
        self.last_render_stats = None

    def C(self, value, step):
        """Scheduled scalar of this system (epoch specs use its train split
        length)."""
        return C(value, step, epoch_steps=self.steps_per_epoch)

    # -- data ---------------------------------------------------------------
    def setup_data(self, dataset):
        """Move a split's arrays (all_images (N,H,W,3), all_fg_masks (N,H,W),
        all_c2w (N,3,4), directions (H,W,3) or (N,H,W,3)) onto the device."""
        self.data = dataset_device_arrays(dataset, self.device)
        self.w = int(dataset.w)
        self.h = int(dataset.h)
        self.n_images = int(self.data["images"].shape[0])
        # one nominal epoch = one pass over the train split's images
        self.steps_per_epoch = self.n_images
        self.has_mask = bool(getattr(dataset, "has_mask", False))
        self.apply_mask = bool(getattr(dataset, "apply_mask", False))
        self.shared_directions = self.data["directions"].ndim == 3

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """The train state: parameters drawn from a CPU ``torch.Generator``
        seeded with ``seed`` (leaf tensors that require grad), the optimizer
        of ``system.optimizer`` / ``system.scheduler``, an all-occupied
        occupancy grid, ``step`` 0 and the device generator, seeded with
        ``seed`` too. ``model.weights`` names a checkpoint whose parameters
        and grid are loaded (reference models/base.py:12-13)."""
        params = make_trainable(self.model.init(torch.Generator().manual_seed(seed), self.device))
        optimizer, self.lr_fn = make_optimizer(
            self.config.system.optimizer, self.config.system.get("scheduler", None), params,
            epoch_steps=self.steps_per_epoch,
        )
        init_extra = getattr(self.model, "init_extra_state", None)
        state = {
            "params": params,
            "optimizer": optimizer,
            "occ": self.model.init_occupancy(self.device),
            "extra": init_extra(self.device) if init_extra is not None else {},
            "step": 0,
            "generator": torch.Generator(device=self.device).manual_seed(seed),
        }
        weights = self.config.model.get("weights", None)
        if weights:
            from instant_nsr_pl_tpu_torch.utils.checkpoint import load_weights_only

            state = load_weights_only(weights, state)
        return state

    # -- sampling (reference systems/nerf.py:33-85) -------------------------
    def _sample_rays(self, data, generator, n):
        """Random images and pixels of the train split: rays (unit
        directions), their colours and foreground masks."""
        dev = data["images"].device
        if self.batch_image_sampling:
            idx = torch.randint(0, self.n_images, (n,), generator=generator, device=dev)
        else:
            idx = torch.randint(0, self.n_images, (1,), generator=generator,
                                device=dev).expand(n)
        x = torch.randint(0, self.w, (n,), generator=generator, device=dev)
        y = torch.randint(0, self.h, (n,), generator=generator, device=dev)
        if self.shared_directions:
            dirs_cam = data["directions"][y, x]
        else:
            dirs_cam = data["directions"][idx, y, x]
        rays_o, rays_d = get_rays(dirs_cam, data["c2w"][idx])
        rays_d = rays_d / torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-10)
        rgb = pixels_to_f32(data["images"][idx, y, x])
        fg_mask = pixels_to_f32(data["fg_masks"][idx, y, x])
        return rays_o, rays_d, rgb, fg_mask

    def _background_color(self, generator, n, train: bool):
        """white / random / black; validation always renders on white
        (reference systems/nerf.py:69-76)."""
        mode = self.background_color_mode if train else "white"
        if mode == "white":
            return torch.ones(3, dtype=torch.float32, device=self.device)
        if mode == "black":
            return torch.zeros(3, dtype=torch.float32, device=self.device)
        if mode == "random":
            return torch.rand((n, 3), generator=generator, device=self.device)
        raise ValueError(f"Unknown background_color '{mode}'")

    # -- train step -----------------------------------------------------------
    def loss_fn(self, params, occ, batch, generator, step, n_rays=None, capacity=None,
                extra=None):
        """(loss, metrics) of one batch; the loss is differentiable with
        respect to ``params``. ``extra``: the model's non-gradient state."""
        raise NotImplementedError

    def update_occupancy(self, state, warmup: bool):
        """One grid update of the state (reference models/nerf.py:45-55 via
        nerfacc ``every_n_step``): every cell while warming up, else the slab
        of update ordinal (step // grid_update_every) mod 8, or the random
        cells with ``grid_update_sampling: random``."""
        phase = None
        if not warmup and self.grid_update_sampling == "slab":
            phase = (state["step"] // self.grid_update_every) % 8
        state["occ"] = self.model.update_occupancy(
            state["params"], state["occ"], state["generator"], warmup=warmup, phase=phase,
            step=state["step"],
        )
        return state

    def train_step(self, state):
        """One training step, updating ``state`` in place (and returning it
        with the step's metrics): the grid update when ``step`` is a multiple
        of ``grid_update_every`` (warmup below ``grid_warmup_steps``), then
        sample rays, forward, loss, backward and the optimizer update
        (reference on_train_batch_start -> training_step ordering,
        systems/base.py:54-57). Metrics are 0-d tensors or floats; reading
        them waits for the device."""
        step = state["step"]
        if step % self.grid_update_every == 0:
            self.update_occupancy(state, warmup=step < self.grid_warmup_steps)
        n_rays = self.active_num_rays
        gen = state["generator"]
        rays_o, rays_d, rgb, fg_mask = self._sample_rays(self.data, gen, n_rays)
        bg = self._background_color(gen, n_rays, train=True)
        if self.apply_mask:
            rgb = rgb * fg_mask[:, None] + bg.expand_as(rgb) * (1.0 - fg_mask[:, None])
        batch = {"rays_o": rays_o, "rays_d": rays_d, "rgb": rgb, "fg_mask": fg_mask,
                 "background_color": bg}
        optimizer = state["optimizer"]
        optimizer.zero_grad()
        loss, metrics = self.loss_fn(state["params"], state["occ"], batch, gen, step,
                                     n_rays=n_rays, extra=state.get("extra"))
        loss.backward()
        optimizer.step(step)
        update_extra = getattr(self.model, "update_extra_state", None)
        if update_extra is not None:
            state["extra"] = update_extra(state["params"], state.get("extra", {}), step)
        metrics["train/loss"] = loss.detach()
        metrics["train/lr"] = optimizer.lr(step)
        state["step"] = step + 1
        return state, metrics

    def train_chunk(self, state, n: int):
        """``n`` training steps; returns (state, the last step's metrics).
        The JAX package runs them as one compiled scan between grid updates;
        the port runs them one by one."""
        metrics = None
        for _ in range(n):
            state, metrics = self.train_step(state)
        return state, metrics

    def adapt_num_rays(self, live_samples: float):
        """Bucketed dynamic ray batching (the reference's EMA ``n_rays <-
        0.9n + 0.1n * target/actual``, systems/nerf.py:93-95): the largest
        bucket whose expected live-sample count fits 90% of the packed
        capacity. Called at log cadence."""
        if not self.dynamic_ray_sampling or live_samples <= 0:
            return self.active_num_rays
        per_ray = live_samples / self.active_num_rays
        desired = 0.9 * self.train_capacity / max(per_ray, 1e-6)
        new = self.ray_buckets[0]
        for b in self.ray_buckets:
            if b <= desired:
                new = b
        self.active_num_rays = new
        return new

    # -- evaluation ---------------------------------------------------------
    def forward_eval(self, params, occ, rays_o, rays_d, bg, step=0, capacity=None):
        raise NotImplementedError

    def render_chunk(self, state, rays_o, rays_d, capacity_scale: int = 1):
        """One fixed-size chunk on a white background at the state's step
        (the JAX package's jitted ``make_render_chunk``)."""
        bg = torch.ones(3, dtype=torch.float32, device=rays_o.device)
        return self.forward_eval(
            state["params"], state["occ"], rays_o, rays_d, bg, step=state.get("step", 0),
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
