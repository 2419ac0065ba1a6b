"""Where the time of one rendered view goes, for the PyTorch port on a CUDA
card: the bench NeRF of chip_smoke.py (random weights, occupancy grid from
the scene SDF), one warm 256x256 view.

    python3 scripts/profile_torch_render.py [--out chiprun_out/profile_render.json]

Prints (and writes as JSON):
- per-stage host wall of one eval chunk, each stage ending in a synchronize
  (march, density head, radiance head, compositing), median of 10;
- for one whole view under torch.profiler: wall, summed device kernel time,
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile_render.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_render: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.ops.ray import get_rays
    from instant_nsr_pl_tpu_torch.registry import datasets, systems

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cfg = config_from_dict(chip_smoke.bench_config())
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("validate")
    system = systems.make(cfg.system.name, cfg)
    system.setup_data(dm.val)
    state = system.init_state(seed=chip_smoke.SEED)
    state["occ"] = chip_smoke.scene_grid(system.model, cfg.dataset.spheres, device)
    model = system.model
    system.render_image(state, 0)  # warm-up: builds, cuBLAS handles, allocator

    # per-stage wall of the middle chunk
    data = system.data
    ro, rd = get_rays(data["directions"].reshape(-1, 3), data["c2w"][0])
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    sl = slice(8 * 4096, 9 * 4096)
    ro, rd = ro[sl].contiguous(), rd[sl].contiguous()
    params, occ, bg = state["params"], state["occ"], torch.ones(3, device=device)
    cap = system.eval_capacity
    stages = {"march": [], "density": [], "radiance": [], "composite": []}
    with torch.no_grad():  # the eval path: parameters require grad for training
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples, positions, dirs, t_mid, grp = model.march(occ, ro, rd, cap)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            density, feature = model.geometry.apply(params["geometry"], positions)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rgb = model.texture.apply(params["texture"], feature, dirs)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            model.composite(samples, density, rgb, t_mid, bg, grp)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for k, a, b in (("march", t0, t1), ("density", t1, t2), ("radiance", t2, t3),
                            ("composite", t3, t4)):
                stages[k].append((b - a) * 1e3)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    live = int(samples.valid.sum())

    # one whole view under the profiler
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.render_image(state, 0)
        torch.cuda.synchronize()
        view_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    result = {
        "card": chip_smoke.nvidia_smi_line(),
        "chunk": {"rays": 4096, "capacity": cap, "live_samples": live, "stage_ms": stage_ms},
        "view": {"rays": 65536, "wall_s": view_s, "rays_per_s": 65536 / view_s,
                 "device_kernel_ms": busy_us / 1e3,
                 "device_busy_share": busy_us / 1e6 / view_s,
                 "n_kernel_launches": len(kernels)},
        "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top],
    }
    print(json.dumps(result, indent=1))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
