"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero before the result
lines are printed):

1. environment: torch version, card name and power limit; TF32 off;
2. build: every ``instant_nsr_pl_tpu_torch/csrc/*.cu`` with nvcc (parallel);
3. kernels at the bench NeRF's full width (K1 fused density: CP C=64,
   R=(128, 2048), F=16, MLP 32->64->16; K3 fused radiance: SH degree 4,
   16 features, MLP 32->64->64->3), at N=262,144 and a ragged N=262,107,
   each against its plain PyTorch version on the same inputs, tolerance
   2e-2 * max|plain|, then timed with CUDA events (median of 20 batches of 10
   back-to-back calls, after warm-up);
4. render: the bench system (``bench.py`` ``build_system("cp")`` settings) on
   the 256x256 six-sphere synthetic scene, random weights from a seeded
   torch.Generator and an occupancy grid from the scene SDF, one view through
   ``NeRFSystem.evaluate_image`` with the launch counters read around it, and
   one chunk composited from the kernels' and from the plain versions' outputs;
5. one JSON line ``{"kernels": [...]}`` and the card's name and power limit;
6. the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16 = 989e12  # dense tensor-core rate, bf16 operands
PEAK_F32 = 67e12  # CUDA cores, float32
N_FULL = 262144  # one eval chunk's packed capacity (4,096 rays)
N_RAGGED = 262107
SEED = 0

# bench.py _SPHERES: the six-sphere scene of the bench NeRF
SPHERES = [
    [0.55, 0.0, 0.1, 0.16, 0.8, 0.3, 0.2],
    [-0.5, 0.3, -0.2, 0.14, 0.2, 0.7, 0.3],
    [0.1, -0.55, 0.3, 0.15, 0.25, 0.35, 0.9],
    [-0.2, -0.1, 0.55, 0.12, 0.9, 0.8, 0.2],
    [0.3, 0.5, -0.4, 0.13, 0.6, 0.2, 0.8],
    [-0.55, -0.45, 0.0, 0.12, 0.2, 0.8, 0.8],
]


def bench_config():
    """The bench NeRF (bench.py build_system("cp")), render side."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 64}
    return {
        "dataset": {"name": "synthetic", "size": 256, "n_train": 8, "n_val": 1,
                    "spheres": SPHERES},
        "model": {
            "name": "nerf", "radius": 1.5, "num_samples_per_ray": 1024,
            "eval_chunk_rays": 4096, "eval_num_samples": N_FULL,
            "grid_prune": True, "learned_background": False,
            "geometry": {
                "name": "volume-density", "radius": 1.5, "feature_dim": 16,
                "density_activation": "trunc_exp", "density_bias": -1,
                "xyz_encoding_config": {"otype": "CP", "n_components": 64,
                                        "resolutions": [128, 2048], "n_features": 16},
                "mlp_network_config": {**mlp, "output_activation": "none",
                                       "n_hidden_layers": 1},
            },
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 16,
                "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
                "mlp_network_config": {**mlp, "output_activation": "Sigmoid",
                                       "n_hidden_layers": 2},
            },
        },
        "system": {"name": "nerf-system"},
    }


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, inner=10, warmup=3):
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls of ``fn()``, per call, after warm-up. Back to back, the host queues
    launches faster than the card runs them, so the host's per-call work
    (argument checks, the ctypes call) hides behind the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def with_biases(layers, gen, device):
    """Non-zero biases (the init zeroes them), so the check exercises them."""
    return [{"w": l["w"], "b": (0.1 * torch.randn(l["b"].shape, generator=gen)).to(device)}
            for l in layers]


def compare(name, kernel_out, plain_out):
    err = float((kernel_out - plain_out).abs().max())
    tol = 2e-2 * float(plain_out.abs().max())
    ok = math.isfinite(err) and err <= tol
    print(f"[kernel] {name}: max|kernel - plain| = {err:.3e}  tol 2e-2*max|plain| = {tol:.3e}"
          f"  {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def bound(n_bytes, bf16_flops, f32_flops):
    """Least time for the work: the larger of the bytes over HBM bandwidth
    and the operations over the peak rate of their type (bf16-operand
    products on the tensor cores, float32 products on the CUDA cores)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(device):
    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
    from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init

    gen = torch.Generator().manual_seed(SEED)
    cp_spec = CPSpec(64, (128, 2048), 16)
    d_spec = MLPSpec(dim_in=32, dim_out=16, n_neurons=64, n_hidden_layers=1)
    cp_params = cp_init(gen, cp_spec, device)
    d_layers = with_biases(mlp_init(gen, d_spec, device), gen, device)
    x = torch.rand((N_FULL, 3), generator=gen) * 1.1 - 0.05
    knots = [torch.arange(r, dtype=torch.float32) / (r - 1) for r in cp_spec.resolutions]
    special = torch.cat([torch.tensor([0.0, 1.0, -0.05, 1.05]), *knots])
    x[: special.numel(), 0] = special
    x[: special.numel(), 1] = special.flip(0)
    x[: special.numel(), 2] = special.roll(7)
    x = x.to(device)

    r_spec = MLPSpec(dim_in=32, dim_out=3, n_neurons=64, n_hidden_layers=2,
                     output_activation="Sigmoid")
    r_layers = with_biases(mlp_init(gen, r_spec, device), gen, device)
    feats = torch.randn((N_FULL, 16), generator=gen).to(device)
    dirs = torch.nn.functional.normalize(torch.randn((N_FULL, 3), generator=gen), dim=-1).to(device)

    # the kernels alone, on operands packed once (the ops pack per call)
    cp_ops = cp_mlp.cp_mlp_operands(cp_params, d_layers, cp_spec, d_spec)
    sh_ops = sh_mlp.pack_sh_mlp(r_layers, r_spec, 4, 16, 16)
    entries = []
    specs = [
        ("cp_mlp_forward", "cp_mlp_fwd.cu", "instant_nsr_pl_tpu/ops/cp_mlp_pallas.py:267",
         lambda n: (cp_params, d_layers, x[:n], cp_spec, d_spec), d_spec.dim_out,
         cp_mlp.cp_mlp_forward, cp_mlp.cp_mlp_forward_plain,
         lambda: cp_mlp.cp_mlp_launch(cp_ops, x, cp_spec, d_spec)),
        ("sh_mlp_forward", "sh_mlp_fwd.cu", "instant_nsr_pl_tpu/ops/sh_mlp_pallas.py:195",
         lambda n: (r_layers, feats[:n], dirs[:n], r_spec, 4, 16), r_spec.dim_out,
         sh_mlp.sh_mlp_forward, sh_mlp.sh_mlp_forward_plain,
         lambda: sh_mlp.sh_mlp_launch(sh_ops, feats, dirs, r_spec, 4)),
    ]
    for name, src, replaces, args_of, d_out, op, plain, launch in specs:
        errs = []
        for n in (N_FULL, N_RAGGED):
            args = args_of(n)
            got = op(*args)
            torch.cuda.synchronize()
            assert got.shape == (n, d_out), (name, tuple(got.shape))
            errs.append(compare(f"{name} N={n}", got, plain(*args)))
        args = args_of(N_FULL)
        compare(f"{name} launch on packed operands", launch(), plain(*args))
        ms = time_ms(launch)
        op_ms = time_ms(lambda: op(*args))
        plain_ms = time_ms(lambda: plain(*args))
        if name == "cp_mlp_forward":
            s, c, f = len(cp_spec.resolutions), cp_spec.n_components, cp_spec.n_features
            w, e, dout = d_spec.n_neurons, cp_spec.n_output_dims, d_spec.dim_out
            table_bytes = sum(3 * r * c * 2 for r in cp_spec.resolutions) + s * c * f * 2
            mlp_bytes = (e + w) * w * 2 + 2 * w * 4
            n_bytes = N_FULL * (3 * 4 + dout * 4) + table_bytes + mlp_bytes
            bf16 = N_FULL * (3 * 3 * s * c + 2 * s * c * f + 2 * (e * w + w * dout))
            f32 = N_FULL * 2 * s * c
        else:
            w, dout = r_spec.n_neurons, r_spec.dim_out
            n_bytes = N_FULL * (16 * 4 + 3 * 4 + dout * 4) + (32 + 2 * w) * w * 2 + 3 * w * 4
            bf16 = N_FULL * 2 * (32 * w + w * w + w * dout)
            f32 = N_FULL * 40  # the degree-4 SH polynomials
        bound_ms, bound_by = bound(n_bytes, bf16, f32)
        print(f"[kernel] {name}: {ms:.4f} ms (with operand packing {op_ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by}) at N={N_FULL}",
              flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"instant_nsr_pl_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": 0, "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms, "op_ms": op_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "n": N_FULL,
        })
    return entries


def scene_grid(model, device):
    """Occupied where the scene SDF is below one cell diagonal, at the 128^3
    cell centres (random weights cannot prune as a trained grid does; this
    grid gives the bench's live-sample profile)."""
    from instant_nsr_pl_tpu_torch.datasets.synthetic import scene_sdf
    from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState, _postprocess_binary

    spec = model.occ_spec
    res, r = spec.resolution, spec.radius
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * r - r
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    spheres = tuple((tuple(s[0:3]), float(s[3]), tuple(s[4:7])) for s in SPHERES)
    sdf = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3), spheres)
    binary = torch.as_tensor(sdf < math.sqrt(3.0) * 2 * r / res, device=device)
    return {"grid": OccupancyGridState(occs=binary.float(), binary=binary,
                                       binary_dilated=_postprocess_binary(binary, spec))}


def render_phase(device):
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.ops.activations import get_activation
    from instant_nsr_pl_tpu_torch.ops.contraction import contract_to_unisphere
    from instant_nsr_pl_tpu_torch.ops.ray import get_rays
    from instant_nsr_pl_tpu_torch.registry import datasets, systems

    cfg = config_from_dict(bench_config())
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("validate")
    system = systems.make(cfg.system.name, cfg)  # on CUDA by default
    assert system.device.type == "cuda"
    system.setup_data(dm.val)
    state = system.init_state(seed=SEED)
    state["occ"] = scene_grid(system.model, device)
    model = system.model
    assert model.geometry.encoding_with_network.fused and model.texture.fused

    # the main path: one view, launch counters read just around it
    cp_mlp.cp_mlp_forward.launches = 0
    sh_mlp.sh_mlp_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = system.evaluate_image(state, 0)
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    launches = {"cp_mlp_forward": cp_mlp.cp_mlp_forward.launches,
                "sh_mlp_forward": sh_mlp.sh_mlp_forward.launches}
    stats = system.last_render_stats
    imgs = res["images"]
    n_rays = system.w * system.h
    print(f"[render] view 0: {view_s:.3f} s, {n_rays / view_s:.0f} rays/s (first view), "
          f"PSNR {res['psnr']:.3f} dB, SSIM {res['ssim']:.4f}, {stats}, launches {launches}",
          flush=True)
    assert stats["rays"] == n_rays and stats["rays_kept"] == n_rays, stats
    for k in ("comp_rgb", "opacity", "depth"):
        assert np.isfinite(imgs[k]).all(), k
    for k in ("comp_rgb", "opacity"):
        assert imgs[k].min() >= 0.0 and imgs[k].max() <= 1.0 + 1e-6, (k, imgs[k].min(), imgs[k].max())
    assert imgs["comp_rgb"].shape == (system.h, system.w, 3)
    assert 0.0 < float(imgs["opacity"].mean()) < 1.0
    for name, count in launches.items():
        assert count >= 16, (name, count)

    # warm render rate of the same view (not counted in the launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.render_image(state, 0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"[render] view 0 again: {warm_s:.3f} s, {n_rays / warm_s:.0f} rays/s", flush=True)

    # one chunk (the image's middle rows) marched once, composited from the
    # kernels' outputs and from the plain versions' outputs
    data = system.data
    ro, rd = get_rays(data["directions"].reshape(-1, 3), data["c2w"][0])
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    sl = slice(8 * 4096, 9 * 4096)
    ro, rd = ro[sl].contiguous(), rd[sl].contiguous()
    params, bg = state["params"], torch.ones(3, device=device)
    samples, positions, dirs, t_mid, grp = model.march(state["occ"], ro, rd, N_FULL)
    geo, tex = model.geometry, model.texture
    ewn = geo.encoding_with_network
    pts = contract_to_unisphere(positions, geo.radius, geo.contraction_type)
    outs = {}
    for label, cp_fn, sh_fn in (
        ("kernels", cp_mlp.cp_mlp_forward, sh_mlp.sh_mlp_forward),
        ("plain", cp_mlp.cp_mlp_forward_plain, sh_mlp.sh_mlp_forward_plain),
    ):
        out = cp_fn(params["geometry"]["encoding"]["cp"], params["geometry"]["network"]["layers"],
                    pts, ewn.encoding.encoding.spec, ewn.network.spec)
        density = geo.density_activation(out[:, 0] + geo.density_bias)
        rgb = get_activation("sigmoid")(sh_fn(params["texture"]["network"]["layers"], out, dirs,
                                              tex.network.spec, tex._sh_degree, 16))
        outs[label] = model.composite(samples, density, rgb, t_mid, bg, grp)
    torch.cuda.synchronize()
    delta = float((outs["kernels"]["comp_rgb"] - outs["plain"]["comp_rgb"]).abs().max())
    live = int(samples.valid.sum())
    assert live > 0, "the compared chunk has no live samples"
    print(f"[render] chunk 8: {live} live samples, max|d comp_rgb| kernels vs plain = "
          f"{delta:.3e} (limit 2e-2)", flush=True)
    if not delta <= 2e-2:
        raise AssertionError("composited chunk: kernels and plain versions disagree")
    return launches, n_rays / view_s, n_rays / warm_s


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from instant_nsr_pl_tpu_torch.ops import cuda_build

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}", flush=True)
    # plain versions and SSIM are float32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = cuda_build.build_all()
    print(f"[build] {build_s:.1f} s for {sorted(cuda_build.BUILD_LOG) or 'cached libraries'}",
          flush=True)
    for stem, log in sorted(cuda_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {stem}: {line.strip()}", flush=True)

    entries = kernel_phase(device)
    launches, rays_per_s, warm_rays_per_s = render_phase(device)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(f"[render] rays/s: {rays_per_s:.0f} first view, {warm_rays_per_s:.0f} warm ({smi})",
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
