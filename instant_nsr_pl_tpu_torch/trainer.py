"""Training orchestration: the PyTorch-Lightning ``Trainer`` role.

Port of ``instant_nsr_pl_tpu/trainer.py`` (``fit`` :90-202, validation
:204-234, test :236-293, predict :295-324, export :326-341, checkpoints
:343-360): the step-based fit loop with the log, validation and checkpoint
cadences, checkpoints written before validation, resume, ``validate``,
``test`` (per-view PNGs with metric sidecars, skipping views a restarted run
already saved, then the mesh export), ``predict`` and ``export``. Images and
meshes go to ``<exp_dir>/save`` (``utils/savers.py``). TensorBoard logging is
not ported (CSV and console logs only).

In a data-parallel run (``--devices``, JAX ``trainer.py:72-344``) every rank
trains and renders (the renders are collective); rank 0 owns the logs,
checkpoints, saved views and the mesh (the torch DDP rank-zero contract).
Rank 0 writes a checkpoint after checking that every rank's state equals its
own to the bit, then the ranks meet at a barrier, so any rank may read it.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from instant_nsr_pl_tpu_torch.parallel.distributed import barrier, process_count, process_index
from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays
from instant_nsr_pl_tpu_torch.utils import savers
from instant_nsr_pl_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_weights_only,
    save_checkpoint,
)
from instant_nsr_pl_tpu_torch.utils.loggers import ConsoleLogger, CSVLogger


class Trainer:
    def __init__(self, config, exp_dir, loggers=None):
        self.config = config
        tcfg = config.trainer
        self.max_steps = int(tcfg.max_steps)
        self.log_every_n_steps = int(tcfg.get("log_every_n_steps", 100))
        self.val_check_interval = int(tcfg.get("val_check_interval", 0) or 0)
        self.limit_val_batches = int(tcfg.get("limit_val_batches", 0) or 1 << 30)
        ckpt_cfg = config.get("checkpoint", None) or {}
        self.ckpt_every = int(ckpt_cfg.get("every_n_train_steps", self.max_steps) or 0)
        # the reference's save_top_k with monitor=None (launch.py:72-75): -1
        # keeps every checkpoint, 0 saves none, k > 0 keeps the k newest
        self.save_top_k = int(ckpt_cfg.get("save_top_k", -1))
        # render N val views before training to fail fast on the eval path
        self.num_sanity_val_steps = int(tcfg.get("num_sanity_val_steps", 0))
        self.exp_dir = exp_dir
        self.save_dir = os.path.join(exp_dir, "save")
        self.ckpt_dir = os.path.join(exp_dir, "ckpt")
        os.makedirs(self.save_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.is_main = process_index() == 0
        if loggers is None:
            loggers = ([CSVLogger(os.path.join(exp_dir, "csv_logs")),
                        ConsoleLogger(interval=self.log_every_n_steps)] if self.is_main else [])
        self.loggers = loggers

    def _log(self, metrics, step):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    # -- fit ---------------------------------------------------------------
    def fit(self, system, dm, resume=None, resume_weights_only=False):
        """Train ``system`` on ``dm``'s train split up to ``trainer.max_steps``
        and return the final state. Logs every ``log_every_n_steps`` (with
        ``train/rays_per_sec`` over the interval, host clock around work
        that ends reading the metrics, which waits for the device), saves a
        checkpoint every ``checkpoint.every_n_train_steps`` and then
        validates every ``val_check_interval``; a final checkpoint closes
        the run."""
        dm.setup("fit")
        system.setup_data(dm.train)
        state = system.init_state(seed=int(self.config.get("seed", 42)))
        if resume:
            load = load_weights_only if resume_weights_only else load_checkpoint
            state = system.replicate(load(resume, state))
        val_data = dataset_device_arrays(dm.val, system.device)

        for i in range(min(int(val_data["images"].shape[0]), self.num_sanity_val_steps)):
            system.evaluate_image(state, i, data=val_data)

        start_step = int(state["step"])
        fit_t0 = t0 = time.time()
        aux_secs = 0.0  # checkpoint and validation time, not training
        rays_done = 0
        metrics = None
        step = start_step
        while step < self.max_steps:
            state, metrics = system.train_step(state)
            rays_done += system.active_num_rays
            step = int(state["step"])
            if step % self.log_every_n_steps == 0 or step == self.max_steps:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                metrics["train/rays_per_sec"] = rays_done / max(dt, 1e-9)
                metrics["train/num_rays"] = system.active_num_rays
                t0, rays_done = time.time(), 0
                self._log(metrics, step)
                system.adapt_num_rays(metrics.get("train/num_samples", 0.0))
            # checkpoint BEFORE validation: a run killed during a long
            # render resumes at this step
            if self.ckpt_every and step % self.ckpt_every == 0:
                ta = time.time()
                self.save(state, step, system)
                aux_secs += time.time() - ta
            if self.val_check_interval and step % self.val_check_interval == 0:
                ta = time.time()
                self._run_validation(system, state, val_data, step)
                aux_secs += time.time() - ta
        if (self.val_check_interval and start_step >= self.max_steps
                and self.max_steps % self.val_check_interval == 0):
            # resumed AT max_steps: run the final validation the loop skipped
            self._run_validation(system, state, val_data, start_step)
        self.save(state, int(state["step"]), system)
        wall = time.time() - fit_t0
        self._log({"train/fit_wall_secs": wall, "train/train_wall_secs": wall - aux_secs,
                   "train/fit_start_step": float(start_step)}, int(state["step"]))
        return state

    def _run_validation(self, system, state, val_data, step):
        n = min(int(val_data["images"].shape[0]), self.limit_val_batches)
        psnrs, ssims = [], []
        for i in range(n):
            res = system.evaluate_image(state, i, data=val_data)
            psnrs.append(res["psnr"])
            ssims.append(res["ssim"])
            if self.is_main:
                savers.save_image_grid(self.save_dir, f"it{step}-{i}.png",
                                       system.image_grid_specs(res))
                print(f"[val] view {i}: psnr={res['psnr']:.2f} ssim={res['ssim']:.4f}",
                      flush=True)
        self._log({"val/psnr": float(np.mean(psnrs)), "val/ssim": float(np.mean(ssims))}, step)
        return float(np.mean(psnrs))

    # -- validate ------------------------------------------------------------
    def validate(self, system, dm, state):
        """Render the val split with ``state``; logs and returns the mean
        PSNR (and logs SSIM)."""
        dm.setup("validate")
        data = dataset_device_arrays(dm.val, system.device)
        return self._run_validation(system, state, data, int(state["step"]))

    def test(self, system, dm, state):
        """Render the test split: ``it{step}-test/{i}.png`` panels with a
        ``{i}.json`` metric sidecar each (a view that already has both, from
        a run restarted into the same trial, is read back, not rendered
        again; single-process only: ranks that disagreed on a file would
        leave the collective render), the mean test/psnr and test/ssim
        logged, the frames assembled into a sequence, then the mesh export.
        Returns the mean PSNR."""
        dm.setup("test")
        data = dataset_device_arrays(dm.test, system.device)
        step = int(state["step"])
        psnrs, ssims = [], []
        for i in range(int(data["images"].shape[0])):
            png = os.path.join(self.save_dir, f"it{step}-test", f"{i}.png")
            sidecar = png[:-4] + ".json"
            if process_count() == 1 and os.path.exists(png) and os.path.exists(sidecar):
                with open(sidecar) as f:
                    cached = json.load(f)
                psnrs.append(cached["psnr"])
                ssims.append(cached["ssim"])
                print(f"[test] view {i}: cached ({png})", flush=True)
                continue
            res = system.evaluate_image(state, i, data=data)
            psnrs.append(res["psnr"])
            ssims.append(res["ssim"])
            if self.is_main:
                savers.save_image_grid(self.save_dir, f"it{step}-test/{i}.png",
                                       system.image_grid_specs(res))
                savers.save_json(self.save_dir, f"it{step}-test/{i}.json",
                                 {"psnr": float(res["psnr"]), "ssim": float(res["ssim"])})
                print(f"[test] view {i}: psnr={res['psnr']:.2f} ssim={res['ssim']:.4f}",
                      flush=True)
        psnr = float(np.mean(psnrs))
        self._log({"test/psnr": psnr, "test/ssim": float(np.mean(ssims))}, step)
        self._save_sequence(f"it{step}-test")
        self.export(system, state)
        return psnr

    def predict(self, system, dm, state):
        """Render the predict split (the train split's cameras, reference
        datasets/blender.py:109-110) to ``it{step}-predict/{i}.png`` and a
        sequence; no metrics. Returns the number of views."""
        dm.setup("predict")
        data = dataset_device_arrays(dm.predict, system.device)
        step = int(state["step"])
        n = int(data["images"].shape[0])
        for i in range(n):
            images = system.render_image(state, i, data=data)
            if self.is_main:
                savers.save_image_grid(self.save_dir, f"it{step}-predict/{i}.png",
                                       [{"type": "rgb", "img": images["comp_rgb"]}])
        self._save_sequence(f"it{step}-predict")
        return n

    def _save_sequence(self, name):
        if not self.is_main:
            return
        savers.save_img_sequence(self.save_dir, name, os.path.join(self.save_dir, name),
                                 r"(\d+)\.png",
                                 save_format=self.config.trainer.get("video_format", "mp4"),
                                 fps=30)

    def export(self, system, state):
        """The mesh of ``state`` at its step (``model.export`` with the
        config's ``export`` section) to ``it{step}-{model.name}.obj``;
        returns it (rank 0 alone exports; the other ranks return None)."""
        if not self.is_main:
            return None
        step = int(state["step"])
        mesh = system.model.export(state["params"], self.config.get("export", None) or {},
                                   step=step)
        savers.save_obj(self.save_dir, f"it{step}-{self.config.model.get('name', 'model')}.obj",
                        mesh["v_pos"], mesh["t_pos_idx"], v_rgb=mesh.get("v_rgb"))
        return mesh

    def save(self, state, step, system):
        """The checkpoint of ``state``: under ``system``'s plan the ranks'
        states are checked equal (``check_replicas``), rank 0 writes it and
        every rank waits at a barrier. Returns its path on rank 0."""
        if self.save_top_k == 0:
            return None
        if system.plan is not None:
            system.plan.check_replicas(state)
        path = None
        if self.is_main:
            path = save_checkpoint(os.path.join(self.ckpt_dir, f"step={step}.ckpt"), state)
            if self.save_top_k > 0:
                kept = sorted(
                    (f for f in os.listdir(self.ckpt_dir)
                     if f.startswith("step=") and f.endswith(".ckpt")),
                    key=lambda f: int(f[len("step="):].split(".")[0]),
                )
                for old in kept[: -self.save_top_k]:
                    os.remove(os.path.join(self.ckpt_dir, old))
        barrier()
        return path
