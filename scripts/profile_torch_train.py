"""Where the time of one training step goes, for the PyTorch port on a CUDA
card: the bench NeRF or the bench NeuS of chip_smoke.py (8,192 rays and
262,144 packed samples per step), or any NeRF or NeuS config given with
``--config`` (the stacked ones: ``instant_nsr_pl_tpu_torch/configs/
{nerf,neus}-cp-stacked-synthetic.yaml``), after 40 warm-up steps from random
weights.

    python3 scripts/profile_torch_train.py [--model nerf|neus] [--config x.yaml]
        [--out profile_train.json]

Prints as JSON (and writes to ``--out`` when given), with the card's name
and power limit:
- the host wall of one step split into stages, each ending in a
  synchronize, median of 10 steps. NeRF: ray sampling, march, the density
  and radiance forwards (training mode: K1 or, stacked, K13; K3),
  compositing and the loss, autograd of compositing, the rest of the
  backward (K2 or K14, K4 and the small ops around them), AdamW. NeuS: ray
  sampling, march, the SDF encoding and its Jacobian (K9 per scale or, stacked,
  K11 once), the SDF MLP with its three tangents, K3 (radiance with the
  normals), compositing and the loss, the backward (K10 or K12, K4, the
  MLP's second-order graph and compositing), AdamW. Both add the grid update
  amortised over its cadence (one slab update every 16 steps);
- for 10 whole steps under torch.profiler: wall, summed device kernel time,
  the device's busy share (kernel time / wall) and the top device kernels.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def nerf_stages(system, state):
    """The NeRF step's stages, median of 10 steps, and the live samples."""
    from instant_nsr_pl_tpu_torch.systems.criterions import smooth_l1_loss

    model, params, opt, gen = system.model, state["params"], state["optimizer"], state["generator"]
    n_rays, capacity = system.active_num_rays, system.train_capacity

    names = ["sample", "march", "density_radiance_forward", "composite_loss",
             "composite_backward", "density_radiance_backward", "adamw"]
    stages = {k: [] for k in names}
    live = []
    for rep in range(10):
        step = state["step"] + rep
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        rays_o, rays_d, rgb, fg = system._sample_rays(system.data, gen, n_rays)
        bg = system._background_color(gen, n_rays, train=True)
        rgb = rgb * fg[:, None] + bg * (1.0 - fg[:, None])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        jitter = torch.rand(n_rays, generator=gen, device=rays_o.device)
        samples, positions, dirs, t_mid, grp = model.march(state["occ"], rays_o, rays_d,
                                                           capacity, jitter)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.zero_grad()
        density, feature = model.geometry.apply(params["geometry"], positions)
        color = model.texture.apply(params["texture"], feature, dirs)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = model.composite(samples, density, color, t_mid, bg, grp)
        mask = (out["rays_valid"][:, 0] & out["rays_kept"]).float()
        per_ray = smooth_l1_loss(out["comp_rgb"], rgb, reduction="none").mean(-1)
        loss = (per_ray * mask).sum() / mask.sum().clamp(min=1.0)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        g_density, g_color = torch.autograd.grad(loss, [density, color], retain_graph=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        torch.autograd.backward([density, color], [g_density, g_color])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.step(step)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, b in zip(names, t[:-1], t[1:]):
            stages[k].append((b - a) * 1e3)
        live.append(int(samples.num_valid))
    return {k: statistics.median(v) for k, v in stages.items()}, live


class _Timed:
    """Wrap a bound method or function: synchronize before and after each
    call and record its host wall in ``ms`` (a list per call)."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.ms = []
        self.end = None
        setattr(owner, name, self)

    def __call__(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        torch.cuda.synchronize()
        self.end = time.perf_counter()
        self.ms.append((self.end - t0) * 1e3)
        return out

    def restore(self):
        setattr(self.owner, self.name, self.fn)


def neus_stages(system, state):
    """The NeuS step's stages, median of 10 steps through system.train_step
    with the stage boundaries timed by wrappers (the model's own code runs),
    and the live samples."""
    model, opt = system.model, state["optimizer"]
    geo = model.geometry
    timed = {
        "sample": _Timed(system, "_sample_rays"),
        "march": _Timed(model, "march"),
        "sdf_encode_with_jac": _Timed(geo.encoding, "apply_with_jac"),
        "sdf_mlp_with_tangents": _Timed(geo.network, "apply_jvp"),
        "radiance": _Timed(model.texture, "apply"),
        "forward_total": _Timed(system, "loss_fn"),
        "adamw": _Timed(opt, "step"),
    }
    stages = {k: [] for k in ("sample", "march", "sdf_encode_with_jac", "sdf_mlp_with_tangents",
                              "radiance", "composite_loss", "backward", "adamw")}
    live = []
    for _ in range(10):
        state, metrics = system.train_step(state)
        t = {k: w.ms[-1] for k, w in timed.items()}
        for k in ("sample", "march", "sdf_encode_with_jac", "sdf_mlp_with_tangents",
                  "radiance", "adamw"):
            stages[k].append(t[k])
        stages["composite_loss"].append(t["forward_total"] - t["march"] - t["sdf_encode_with_jac"]
                                        - t["sdf_mlp_with_tangents"] - t["radiance"])
        # the backward: from the loss's return to the optimizer's start
        stages["backward"].append((timed["adamw"].end - timed["forward_total"].end) * 1e3
                                  - t["adamw"])
        live.append(int(metrics["train/num_samples"]))
    for w in timed.values():
        w.restore()
    return {k: statistics.median(v) for k, v in stages.items()}, live


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("nerf", "neus"), default="nerf",
                    help="the bench NeRF or NeuS of chip_smoke.py (without --config)")
    ap.add_argument("--config", default=None,
                    help="a NeRF or NeuS config yaml to profile instead, e.g. "
                         "instant_nsr_pl_tpu_torch/configs/nerf-cp-stacked-synthetic.yaml")
    ap.add_argument("--out", default=None, help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.registry import datasets, systems

    torch.backends.cuda.matmul.allow_tf32 = False
    path = args.config or (chip_smoke.NEUS_CONFIG if args.model == "neus"
                           else chip_smoke.BENCH_CONFIG)
    cfg = config_from_dict(chip_smoke.bench_config(path))
    model_name = str(cfg.model.name)
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("fit")
    system = systems.make(cfg.system.name, cfg)
    system.setup_data(dm.train)
    state = system.init_state(seed=chip_smoke.SEED)
    for _ in range(40):
        state, _ = system.train_step(state)
    torch.cuda.synchronize()
    model, params, gen = system.model, state["params"], state["generator"]
    n_rays, capacity = system.active_num_rays, system.train_capacity
    stage_ms, live = (neus_stages if model_name == "neus" else nerf_stages)(system, state)

    grid_ms = []
    for rep in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            state["occ"] = model.update_occupancy(params, state["occ"], gen, phase=rep)
        torch.cuda.synchronize()
        grid_ms.append((time.perf_counter() - t0) * 1e3)
    stage_ms["grid_update_amortised"] = statistics.median(grid_ms) / system.grid_update_every
    stage_ms["sum"] = sum(stage_ms.values())

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        state, _ = system.train_step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            state, metrics = system.train_step(state)
        float(metrics["train/loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    result = {
        "model": model_name,
        "config": os.path.relpath(path, ROOT),
        "card": chip_smoke.nvidia_smi_line(),
        "step": {"rays": n_rays, "capacity": capacity, "live_samples_median": statistics.median(live),
                 "stage_ms": stage_ms},
        "profiled_10_steps": {"wall_s": wall, "ms_per_step": wall * 100,
                              "rays_per_s": 10 * n_rays / wall,
                              "device_kernel_ms_per_step": busy_us / 1e4,
                              "device_busy_share": busy_us / 1e6 / wall,
                              "kernel_launches_per_step": len(kernels) / 10},
        "top_kernels_ms_per_step": [[name[:90], us / 1e4] for name, us in top],
    }
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
