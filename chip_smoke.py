"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero before the result
lines are printed):

1. environment: torch version, card name and power limit; TF32 off;
2. build: every ``instant_nsr_pl_tpu_torch/csrc/*.cu`` with nvcc (parallel);
3. kernels at the bench NeRF's full width (K1/K2 fused density forward and
   backward: CP C=64, R=(128, 2048), F=16, MLP 32->64->16; K3/K4 fused
   radiance forward and backward: SH degree 4, 16 features, MLP
   32->64->64->3), at N=262,144 and a ragged N=262,107, each against its
   plain PyTorch version on the same inputs: forwards within 2e-2 *
   max|plain|, backwards (fed the same training-mode residuals) within
   2.5e-2 * max|plain| per gradient tensor, the JAX gradient tests'
   tolerance; then timed with CUDA events (median of 20 batches of 10
   back-to-back calls, after warm-up);
4. render: the bench system (``instant_nsr_pl_tpu_torch/configs/
   nerf-cp-synthetic.yaml``, the settings of ``bench.py``
   ``build_system("cp")``) on the 256x256 six-sphere synthetic scene, random
   weights from a seeded torch.Generator and an occupancy grid from the scene
   SDF, one view through ``NeRFSystem.evaluate_image`` with the launch
   counters read around it, and one chunk composited from the kernels' and
   from the plain versions' outputs;
5. train: the same bench system trained through ``NeRFSystem.train_step``
   (8,192 rays and 262,144 packed samples per step): a gradient check before
   the first step, K1-K4 launched on every step, the loss falling, the
   training PSNR rising, the grid pruning, and the val view at least 3 dB
   above the untrained render; the warm training rate;
6. one JSON line ``{"kernels": [...]}`` and the card's name and power limit;
7. the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16 = 989e12  # dense tensor-core rate, bf16 operands
PEAK_F32 = 67e12  # CUDA cores, float32
N_FULL = 262144  # one eval chunk's / one training step's packed capacity
N_RAGGED = 262107
SEED = 0
TRAIN_STEPS = 300
ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_CONFIG = os.path.join(ROOT, "instant_nsr_pl_tpu_torch", "configs", "nerf-cp-synthetic.yaml")


def bench_config():
    """The bench NeRF (bench.py build_system("cp")) as a plain dict."""
    from instant_nsr_pl_tpu_torch.config import load_config

    return load_config(BENCH_CONFIG).to_dict()


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


def compare(name, kernel_out, plain_out, rel=2e-2):
    err = float((kernel_out - plain_out).abs().max())
    tol = rel * float(plain_out.abs().max())
    ok = math.isfinite(err) and err <= tol
    print(f"[kernel] {name}: max|kernel - plain| = {err:.3e}  tol {rel:g}*max|plain| = {tol:.3e}"
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


def _mlp_macs(dims):
    """Multiply-adds of one sample through layers of widths dims[0] -> ..."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def kernel_phase(device):
    """K1-K4 against their plain versions at the bench widths, then timed."""
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
    d_dout = torch.randn((N_FULL, 16), generator=gen).to(device)
    r_dout = torch.randn((N_FULL, 3), generator=gen).to(device)

    # the kernels alone, on operands packed once (the ops pack per call)
    cp_ops = cp_mlp.cp_mlp_operands(cp_params, d_layers, cp_spec, d_spec)
    sh_ops = sh_mlp.pack_sh_mlp(r_layers, r_spec, 4, 16, 16)
    s_count, c, f = len(cp_spec.resolutions), cp_spec.n_components, cp_spec.n_features
    w, e = d_spec.n_neurons, cp_spec.n_output_dims
    line_bytes = sum(3 * r * c for r in cp_spec.resolutions)  # table entries
    d_dims = [e, w, d_spec.dim_out]
    r_dims = [32, r_spec.n_neurons, r_spec.n_neurons, r_spec.dim_out]
    residual_bytes = {"cp": N_FULL * (3 * s_count * c * 2 + w * 2), "sh": N_FULL * 2 * 64 * 2}
    entries = {}

    # -- forwards, eval and training mode
    specs = [
        ("cp_mlp_forward", "cp", "cp_mlp_fwd.cu", "instant_nsr_pl_tpu/ops/cp_mlp_pallas.py:267",
         lambda n: (cp_params, d_layers, x[:n], cp_spec, d_spec), d_spec.dim_out,
         cp_mlp.cp_mlp_forward, cp_mlp.cp_mlp_forward_plain,
         lambda train: cp_mlp.cp_mlp_launch(cp_ops, x, cp_spec, d_spec, train=train)),
        ("sh_mlp_forward", "sh", "sh_mlp_fwd.cu", "instant_nsr_pl_tpu/ops/sh_mlp_pallas.py:195",
         lambda n: (r_layers, feats[:n], dirs[:n], r_spec, 4, 16), r_spec.dim_out,
         sh_mlp.sh_mlp_forward, sh_mlp.sh_mlp_forward_plain,
         lambda train: sh_mlp.sh_mlp_launch(sh_ops, feats, dirs, r_spec, 4, train=train)),
    ]
    for name, key, src, replaces, args_of, d_out, op, plain, launch in specs:
        errs = []
        for n in (N_FULL, N_RAGGED):
            args = args_of(n)
            got = op(*args)
            torch.cuda.synchronize()
            assert got.shape == (n, d_out), (name, tuple(got.shape))
            errs.append(compare(f"{name} N={n}", got, plain(*args)))
        args = args_of(N_FULL)
        compare(f"{name} launch on packed operands", launch(False)[0], plain(*args))
        # training mode: the same output, and residuals equal to the plain ones
        got, *res = launch(True)
        ref, *ref_res = plain(*args, save_residuals=True)
        compare(f"{name} training mode", got, ref)
        for label, a, b in zip(("vsave", "hsave") if key == "cp" else ("hsave",), res, ref_res):
            frac = float((a != b).float().mean())
            print(f"[kernel] {name} training mode: {label} {tuple(a.shape)} differs from the "
                  f"plain version's in {frac:.2e} of its entries", flush=True)
            if frac > 1e-3:
                raise AssertionError(f"{name}: residual {label} disagrees with its plain version")
            compare(f"{name} training mode {label}", a.float(), b.float())
        ms = time_ms(lambda: launch(False))
        ms_train = time_ms(lambda: launch(True))
        op_ms = time_ms(lambda: op(*args))
        plain_ms = time_ms(lambda: plain(*args))
        if key == "cp":
            table_bytes = line_bytes * 2 + s_count * c * f * 2
            mlp_bytes = (e + w) * w * 2 + 2 * w * 4
            n_bytes = N_FULL * (3 * 4 + d_out * 4) + table_bytes + mlp_bytes
            bf16 = N_FULL * 2 * (3 * s_count * c + s_count * c * f + _mlp_macs(d_dims))
            f32 = N_FULL * 2 * s_count * c
        else:
            n_bytes = N_FULL * (16 * 4 + 3 * 4 + d_out * 4) + (32 + 2 * 64) * 64 * 2 + 3 * 64 * 4
            bf16 = N_FULL * 2 * _mlp_macs(r_dims)
            f32 = N_FULL * 40  # the degree-4 SH polynomials
        bound_ms, bound_by = bound(n_bytes, bf16, f32)
        bound_train_ms, _ = bound(n_bytes + residual_bytes[key], bf16, f32)
        print(f"[kernel] {name}: {ms:.4f} ms eval, {ms_train:.4f} ms training mode (with operand "
              f"packing {op_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by}, {bound_train_ms:.4f} ms with residuals) at N={N_FULL}", flush=True)
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"instant_nsr_pl_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": 0, "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms,
            "ms_train": ms_train, "op_ms": op_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_train_ms": bound_train_ms,
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "n": N_FULL,
        }

    # -- backwards, fed the residuals of a training-mode forward on the same inputs
    bwd_specs = [
        ("cp_mlp_backward", "cp_mlp_bwd.cu", "instant_nsr_pl_tpu/ops/cp_mlp_pallas.py:353"),
        ("sh_mlp_backward", "sh_mlp_bwd.cu", "instant_nsr_pl_tpu/ops/sh_mlp_pallas.py:252"),
    ]
    for name, src, replaces in bwd_specs:
        errs = []
        for n in (N_RAGGED, N_FULL):  # the timing below reuses the N_FULL arguments
            if name == "cp_mlp_backward":
                _, vsave, hsave = cp_mlp.cp_mlp_launch(cp_ops, x[:n], cp_spec, d_spec, train=True)
                _, basis, ws, _ = cp_ops
                args = (x[:n], vsave, hsave, d_dout[:n].contiguous(), basis, ws, cp_spec, d_spec)
                launch, plain = cp_mlp.cp_mlp_backward_launch, cp_mlp.cp_mlp_backward_plain
                labels = [f"d line_{s}" for s in range(s_count)] + ["d basis", "dW", "db"]
            else:
                _, hsave = sh_mlp.sh_mlp_launch(sh_ops, feats[:n], dirs[:n], r_spec, 4, train=True)
                ws, _, fpad = sh_ops
                args = (feats[:n], dirs[:n], hsave, r_dout[:n].contiguous(), ws, fpad, r_spec, 4)
                launch, plain = sh_mlp.sh_mlp_backward_launch, sh_mlp.sh_mlp_backward_plain
                labels = ["dW", "db", "d features"]
            got = launch(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            flat_got = [*got[0], *got[1:]] if name == "cp_mlp_backward" else list(got)
            flat_ref = [*ref[0], *ref[1:]] if name == "cp_mlp_backward" else list(ref)
            for label, a, b in zip(labels, flat_got, flat_ref):
                assert a.shape == b.shape, (name, label, tuple(a.shape), tuple(b.shape))
                errs.append(compare(f"{name} N={n} {label}", a, b, rel=2.5e-2))
        ms = time_ms(lambda: launch(*args))
        plain_ms = time_ms(lambda: plain(*args))
        if name == "cp_mlp_backward":
            n_bytes = (N_FULL * (12 + 3 * s_count * c * 2 + w * 2 + 16 * 4)
                       + s_count * c * f * 2 + (e + w) * w * 2
                       + line_bytes * 4 + s_count * c * f * 4 + (e + w) * w * 4 + 2 * w * 4)
            bf16 = N_FULL * 2 * (3 * s_count * c * f + 2 * _mlp_macs(d_dims) + 2 * 3 * s_count * c)
            f32 = N_FULL * s_count * c * 8
        else:
            n_bytes = (N_FULL * (16 * 4 + 12 + 2 * 64 * 2 + 3 * 4 + 16 * 4)
                       + (32 + 128) * 64 * 2 + (32 + 128) * 64 * 4 + 3 * 64 * 4)
            bf16 = N_FULL * 2 * 2 * _mlp_macs(r_dims)
            f32 = N_FULL * 40
        bound_ms, bound_by = bound(n_bytes, bf16, f32)
        print(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
              f"by {bound_by}) at N={N_FULL}", flush=True)
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"instant_nsr_pl_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": 0, "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function (the line-table "
                            "scatter alone is an index_add_, the rest is an MLP backward)",
            "n": N_FULL,
        }
    return [entries[k] for k in ("cp_mlp_forward", "cp_mlp_backward", "sh_mlp_forward",
                                 "sh_mlp_backward")]


def scene_grid(model, spheres, device):
    """Occupied where the scene SDF is below one cell diagonal, at the 128^3
    cell centres (random weights cannot prune as a trained grid does; this
    grid gives the bench's live-sample profile)."""
    from instant_nsr_pl_tpu_torch.datasets.synthetic import scene_sdf
    from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState, _postprocess_binary

    spec = model.occ_spec
    res, r = spec.resolution, spec.radius
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * r - r
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    spheres = tuple((tuple(s[0:3]), float(s[3]), tuple(s[4:7])) for s in spheres)
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
    state["occ"] = scene_grid(system.model, cfg.dataset.spheres, device)
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
        with torch.no_grad():
            out = cp_fn(params["geometry"]["encoding"]["cp"],
                        params["geometry"]["network"]["layers"],
                        pts, ewn.encoding.encoding.spec, ewn.network.spec)
            density = geo.density_activation(out[:, 0] + geo.density_bias)
            rgb = get_activation("sigmoid")(sh_fn(params["texture"]["network"]["layers"], out,
                                                  dirs, tex.network.spec, tex._sh_degree, 16))
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


def train_phase(device, smi):
    """The bench NeRF trained through NeRFSystem.train_step."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays

    cfg = config_from_dict(bench_config())
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("fit")
    system = systems.make(cfg.system.name, cfg)  # on CUDA by default
    system.setup_data(dm.train)
    val = dataset_device_arrays(dm.val, device)
    state = system.init_state(seed=SEED)
    model, params = system.model, state["params"]
    n_rays = system.active_num_rays
    assert n_rays == int(cfg.model.max_train_num_rays), n_rays
    assert system.train_capacity == int(cfg.model.train_num_samples), system.train_capacity
    assert state["generator"].device.type == device.type

    # the untrained model against the grid its first (warmup) update gives
    # (a generator of its own: the run's draws stay those of the seed)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    occ0 = model.update_occupancy(params, state["occ"], gen, warmup=True)
    untrained = system.evaluate_image({"params": params, "occ": occ0}, 0, data=val)
    print(f"[train] untrained val view: PSNR {untrained['psnr']:.3f} dB", flush=True)

    # before the first step: the loss has a backward and every parameter
    # tensor gets a finite, non-zero gradient
    rays_o, rays_d, rgb, fg = system._sample_rays(system.data, gen, n_rays)
    bg = system._background_color(gen, n_rays, train=True)
    rgb = rgb * fg[:, None] + bg * (1.0 - fg[:, None])
    batch = {"rays_o": rays_o, "rays_d": rays_d, "rgb": rgb, "fg_mask": fg, "background_color": bg}
    loss, _ = system.loss_fn(params, occ0, batch, gen, 0)
    assert loss.grad_fn is not None, "the loss has no backward"
    loss.backward()
    for key, t in named_leaves(params):
        g = t.grad
        if g is None or not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            raise AssertionError(f"parameter {key}: gradient missing, non-finite or zero")
    print(f"[train] gradient check: loss {float(loss.detach()):.5f}, {len(named_leaves(params))} parameter "
          "tensors with finite, non-zero gradients", flush=True)
    state["optimizer"].zero_grad()

    # the main path: TRAIN_STEPS steps, launch counters read around each
    counters = {"cp_mlp_forward": cp_mlp.cp_mlp_forward, "cp_mlp_backward": cp_mlp.cp_mlp_backward,
                "sh_mlp_forward": sh_mlp.sh_mlp_forward, "sh_mlp_backward": sh_mlp.sh_mlp_backward}
    for c in counters.values():
        c.launches = 0
    losses, psnrs, per_step = [], [], []
    warm_from = TRAIN_STEPS - 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_warm = None
    for i in range(TRAIN_STEPS):
        if i == warm_from:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        before = {k: c.launches for k, c in counters.items()}
        state, metrics = system.train_step(state)
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        if min(delta.values()) < 1:
            raise AssertionError(f"step {i}: a kernel was not launched: {delta}")
        if i % system.grid_update_every == 0 and delta["cp_mlp_forward"] < 2:
            raise AssertionError(f"step {i}: the grid update did not run K1: {delta}")
        per_step.append(delta)
        losses.append(metrics["train/loss"])
        psnrs.append(metrics["train/psnr"])
        if i == 0:
            occupied_warm = int(state["occ"]["grid"].binary.sum())
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    totals = {k: c.launches for k, c in counters.items()}
    losses = [float(v) for v in losses]
    psnrs = [float(v) for v in psnrs]
    grid = state["occ"]["grid"]
    occupied = int(grid.binary.sum())
    warm_s = t_end - t_warm
    rays_per_s = 100 * n_rays / warm_s
    print(f"[train] {TRAIN_STEPS} steps in {t_end - t0:.2f} s; launches {totals}; one step "
          f"{per_step[1]}, a grid-update step {per_step[16]}", flush=True)
    for i in sorted({0, 1, 15, 16, 50, 100, 200, TRAIN_STEPS - 1} & set(range(TRAIN_STEPS))):
        print(f"[train] step {i}: loss {losses[i]:.5f} psnr {psnrs[i]:.3f}", flush=True)
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    p_first, p_last = float(np.mean(psnrs[:20])), float(np.mean(psnrs[-20:]))
    print(f"[train] mean loss, first 20 steps {first:.5f}, last 20 {last:.5f}; mean training "
          f"PSNR {p_first:.3f} -> {p_last:.3f} dB; occupied cells {occupied_warm} after the "
          f"warmup update, {occupied} of {grid.binary.numel()} at the end", flush=True)
    assert np.isfinite(losses).all()
    assert last < first, "the loss did not fall"
    assert p_last > p_first, "the training PSNR did not rise"
    assert 0 < occupied < occupied_warm, "the grid did not prune"
    trained = system.evaluate_image(state, 0, data=val)
    print(f"[train] val view after {TRAIN_STEPS} steps: PSNR {trained['psnr']:.3f} dB, SSIM "
          f"{trained['ssim']:.4f} (untrained {untrained['psnr']:.3f} dB)", flush=True)
    assert trained["psnr"] >= untrained["psnr"] + 3.0, "training gained less than 3 dB"
    seen = system.evaluate_image(state, 0)
    print(f"[train] train view 0 after {TRAIN_STEPS} steps: PSNR {seen['psnr']:.3f} dB, SSIM "
          f"{seen['ssim']:.4f}", flush=True)
    print(f"[train] warm: {rays_per_s:.0f} rays/s, {warm_s / 100 * 1e3:.2f} ms per step over the "
          f"last 100 steps ({smi})", flush=True)
    return per_step[1], totals, rays_per_s, warm_s / 100


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
    render_launches, rays_per_s, warm_rays_per_s = render_phase(device)
    print(f"[render] rays/s: {rays_per_s:.0f} first view, {warm_rays_per_s:.0f} warm ({smi})",
          flush=True)
    step_launches, run_launches, train_rays_per_s, s_per_step = train_phase(device, smi)
    for e in entries:
        e["launches"] = step_launches[e["name"]]  # one training step
        e["launches_train_run"] = run_launches[e["name"]]
        if e["name"] in render_launches:
            e["launches_render_view"] = render_launches[e["name"]]
    print(f"[train] rays/s: {train_rays_per_s:.0f} warm, {s_per_step:.4f} s per step ({smi})",
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
