"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions: the bench NeRF and the bench NeuS, rendered and trained.

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
4. CP kernels (K5/K6 the CP product, K9/K10 the product with its Jacobian and
   the basis projection) at the bench NeuS encoding (C=64, F=16) for both
   scales, R=128 and 2048, at N=262,144 and 262,107: training-mode residuals
   equal to the plain versions' to the bit, forwards within 2e-2 and
   gradients within 2.5e-2 of max|plain|; timed as above;
5. render: the bench system (``instant_nsr_pl_tpu_torch/configs/
   nerf-cp-synthetic.yaml``, the settings of ``bench.py``
   ``build_system("cp")``) on the 256x256 six-sphere synthetic scene, random
   weights from a seeded torch.Generator and an occupancy grid from the scene
   SDF, one view through ``NeRFSystem.evaluate_image`` with the launch
   counters read around it, and one chunk composited from the kernels' and
   from the plain versions' outputs;
6. train: the same bench system trained through ``NeRFSystem.train_step``
   (8,192 rays and 262,144 packed samples per step) for TRAIN_STEPS steps: a
   gradient check before the first step, K1-K4 launched on every step, the
   loss falling, the training PSNR rising, the grid pruning, and the val view
   at least 3 dB above the untrained render; the warm training rate; then the
   same for the stacked NeRF (``nerf-cp-stacked-synthetic.yaml``, ``bench.py
   --encoding cp_stacked``) with K13/K14 in place of K1/K2;
7. NeuS training: the bench NeuS (``instant_nsr_pl_tpu_torch/configs/
   neus-cp-synthetic.yaml``, ``bench.py`` ``build_neus_system("cp")``)
   through ``NeuSSystem.train_step`` for NEUS_STEPS steps: gradient checks
   before the first step (every tensor finite, zero only on the CP tables
   and bases, by the sphere init) and after the first update (all
   non-zero), K3/K4/K9/K10 launched on every step and K5 in every grid
   update, the loss falling, the training PSNR and inv_s rising, the grid
   leaving its all-occupied state, the val view 3 dB above the untrained
   render; the warm training rate;
8. NeuS render: the trained model's 256x256 val view (K9 in eval mode, no
   backward launched), again warm, and one 4,096-ray chunk composited from
   the kernels on the card against the plain versions on the CPU;
9. NeuS with finite differences (and the curvature loss) for FD_STEPS
   steps: K5/K6 on every step, finite gradients, a finite loss;
10. the stacked NeuS (``neus-cp-stacked-synthetic.yaml``) trained and
   rendered as in 7 and 8, with K11/K12 in place of K9/K10 and K5 at R=129
   and 2049 in the grid updates;
11. one JSON line ``{"kernels": [...]}`` and the card's name and power limit;
12. the last line ``{"ok": true, "device": {...}}``.

Phase 3 also holds K13/K14 (the stacked fused density forward and backward:
C=64, nested R=(129, 2049) on one 2049-row table of 128 stacked components,
F=16, MLP 32->64->16) and phase 4 K11/K12 (the stacked product with its
Jacobian and the block-diagonal basis) and K5/K6 at R=129 and 2049 against
their plain versions, with the same limits.
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
TRAIN_STEPS = 200
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "instant_nsr_pl_tpu_torch", "configs")
BENCH_CONFIG = os.path.join(CONFIGS, "nerf-cp-synthetic.yaml")
NEUS_CONFIG = os.path.join(CONFIGS, "neus-cp-synthetic.yaml")
NERF_STACKED_CONFIG = os.path.join(CONFIGS, "nerf-cp-stacked-synthetic.yaml")
NEUS_STACKED_CONFIG = os.path.join(CONFIGS, "neus-cp-stacked-synthetic.yaml")
NEUS_STEPS = 200
FD_STEPS = 20


def bench_config(path=BENCH_CONFIG):
    """The bench NeRF (bench.py build_system("cp")), or the bench NeuS with
    ``NEUS_CONFIG``, as a plain dict."""
    from instant_nsr_pl_tpu_torch.config import load_config

    return load_config(path).to_dict()


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


def cp_kernel_phase(device):
    """K5/K6 (the CP product) and K9/K10 (the product with its Jacobian and
    the basis projection) at the bench NeuS encoding (C=64, F=16) for both
    scales (R=128 and 2048), and K5/K6 at the stacked encoding's per-scale
    resolutions (R=129 and 2049: its grid updates and finite differences), at
    N=262,144 and 262,107, each against its plain version on the same inputs,
    then timed. The training-mode residuals must equal the plain ones to the
    bit; forwards lie within 2e-2 * max|plain|, gradients within 2.5e-2 *
    max|plain|."""
    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp

    c, f = 64, 16
    resolutions = (128, 2048)
    stacked_resolutions = (129, 2049)
    gen = torch.Generator().manual_seed(SEED + 7)
    tables = {r: cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
              .to(device) for r in resolutions + stacked_resolutions}
    basis = (torch.randn((c, f), generator=gen) / 8.0).to(torch.bfloat16).to(device)
    u3 = torch.rand((3, N_FULL), generator=gen) * 1.1 - 0.05
    off = 8
    for r in tables:  # exact 0 and 1, out of range, and every knot of each scale
        knots = torch.arange(r, dtype=torch.float32) / (r - 1)
        special = torch.cat([torch.tensor([0.0, 1.0, -0.05, 1.05]), knots])
        u3[0, off:off + special.numel()] = special
        u3[1, off:off + special.numel()] = special.flip(0)
        u3[2, off:off + special.numel()] = special.roll(11)
        off += special.numel()
    u3 = u3.to(device)
    dprod = torch.randn((c, N_FULL), generator=gen).to(device)
    denc = torch.randn((f, N_FULL), generator=gen).to(device)
    djac = torch.randn((3, f, N_FULL), generator=gen).to(device)
    table_bytes = {r: 3 * r * c for r in tables}  # entries of one scale's stack

    def residuals_equal(name, got, ref):
        for label, a, b in zip(("vsave", "gdsave"), got, ref):
            if not torch.equal(a, b):
                frac = float((a != b).float().mean())
                raise AssertionError(f"{name}: residual {label} differs from the plain "
                                     f"version's in {frac:.2e} of its entries")
        print(f"[kernel] {name}: training-mode residuals equal the plain version's to the bit",
              flush=True)

    out = {}
    for name in ("cp_product_forward", "cp_product_backward", "cp_jac_basis_forward",
                 "cp_jac_basis_backward"):
        out[name] = {"errs": [], "ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {}}
    for r in resolutions + stacked_resolutions:
        lines = tables[r]
        with_jac = r in resolutions  # the stacked encoding's jac path is K11/K12
        for n in (N_RAGGED, N_FULL):  # the timing below reuses the N_FULL arguments
            u = u3[:, :n].contiguous()
            tag = f"R={r} N={n}"
            # K5: eval and training mode
            prod_e, _ = cpp.cp_product_launch(lines, u, r)
            prod, vsave = cpp.cp_product_launch(lines, u, r, train=True)
            torch.cuda.synchronize()
            ref, ref_v = cpp.cp_product_plain(lines, u, r, save_residuals=True)
            residuals_equal(f"cp_product_forward {tag}", (vsave,), (ref_v,))
            assert torch.equal(prod, prod_e), "K5 eval and training mode disagree"
            out["cp_product_forward"]["errs"].append(compare(f"cp_product_forward {tag}", prod, ref))
            # K6 from those residuals
            dp = dprod[:, :n].contiguous()
            got = cpp.cp_product_backward_launch(lines, u, vsave, dp, r)
            torch.cuda.synchronize()
            ref_b = cpp.cp_product_backward_plain(lines, u, vsave, dp, r)
            for label, a, b in zip(("d lines", "d u"), got, ref_b):
                out["cp_product_backward"]["errs"].append(
                    compare(f"cp_product_backward {tag} {label}", a, b, rel=2.5e-2))
            if not with_jac:
                continue
            # K9: eval and training mode
            enc_e, jac_e, v_e, g_e = cpp.cp_product_jac_basis_launch(lines, basis, u, r)
            enc, jac, vsave_j, gdsave = cpp.cp_product_jac_basis_launch(lines, basis, u, r,
                                                                        train=True)
            torch.cuda.synchronize()
            assert v_e is None and g_e is None, "K9 eval mode wrote residuals"
            assert torch.equal(enc, enc_e) and torch.equal(jac, jac_e)
            ref_j = cpp.cp_product_jac_basis_plain(lines, basis, u, r, save_residuals=True)
            residuals_equal(f"cp_jac_basis_forward {tag}", (vsave_j, gdsave), ref_j[2:])
            for label, a, b in zip(("enc", "jac"), (enc, jac), ref_j[:2]):
                out["cp_jac_basis_forward"]["errs"].append(
                    compare(f"cp_jac_basis_forward {tag} {label}", a, b))
            # K10 from those residuals
            de, dj = denc[:, :n].contiguous(), djac[:, :, :n].contiguous()
            got = cpp.cp_product_jac_basis_backward_launch(u, vsave_j, gdsave, de, dj, basis, r)
            torch.cuda.synchronize()
            ref_b = cpp.cp_product_jac_basis_backward_plain(u, vsave_j, gdsave, de, dj, basis, r)
            for label, a, b in zip(("d lines", "d u", "d basis"), got, ref_b):
                out["cp_jac_basis_backward"]["errs"].append(
                    compare(f"cp_jac_basis_backward {tag} {label}", a, b, rel=2.5e-2))

        # timing at N_FULL (one launch per scale on the main path), bound from
        # the bytes each function must move and its f32 operations
        n = N_FULL
        tb = table_bytes[r]
        timed = {
            "cp_product_forward": (
                lambda: cpp.cp_product_launch(lines, u, r, train=True),
                lambda: cpp.cp_product_plain(lines, u, r, save_residuals=True),
                n * (12 + 4 * c + 6 * c) + 2 * tb, n * c * 11),
            "cp_product_backward": (
                lambda: cpp.cp_product_backward_launch(lines, u, vsave, dp, r),
                lambda: cpp.cp_product_backward_plain(lines, u, vsave, dp, r),
                n * (12 + 6 * c + 4 * c + 12) + 2 * tb + 4 * tb, n * c * 18),
            "cp_jac_basis_forward": (
                lambda: cpp.cp_product_jac_basis_launch(lines, basis, u, r, train=True),
                lambda: cpp.cp_product_jac_basis_plain(lines, basis, u, r, save_residuals=True),
                n * (12 + 16 * f + 12 * c) + 2 * tb + 2 * c * f, n * c * (23 + 8 * f)),
            "cp_jac_basis_backward": (
                lambda: cpp.cp_product_jac_basis_backward_launch(u, vsave_j, gdsave, de, dj,
                                                                 basis, r),
                lambda: cpp.cp_product_jac_basis_backward_plain(u, vsave_j, gdsave, de, dj,
                                                                basis, r),
                n * (12 + 12 * c + 16 * f + 12) + 4 * tb + 2 * c * f + 4 * c * f,
                n * c * (40 + 16 * f)),
        }
        for name, (kern, plain, n_bytes, f32_ops) in timed.items():
            if not with_jac and name.startswith("cp_jac"):
                continue
            e = out[name]
            e["ms"][r] = time_ms(kern)
            e["plain_ms"][r] = time_ms(plain, reps=5, inner=2)
            e["bound_ms"][r], e["bound_by"][r] = bound(n_bytes, 0, f32_ops)
            print(f"[kernel] {name} R={r}: {e['ms'][r]:.4f} ms (plain {e['plain_ms'][r]:.3f} "
                  f"ms; bound {e['bound_ms'][r]:.4f} ms by {e['bound_by'][r]}) at N={n}",
                  flush=True)

    meta = {
        "cp_product_forward": ("cp_product_fwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:242"),
        "cp_product_backward": ("cp_product_bwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:277"),
        "cp_jac_basis_forward": ("cp_jac_basis_fwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:633"),
        "cp_jac_basis_backward": ("cp_jac_basis_bwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:676"),
    }
    entries = []
    for name, (src, replaces) in meta.items():
        e = out[name]
        by = e["bound_by"][resolutions[-1]]
        entry = {
            "name": name, "route": "cuda", "source": f"instant_nsr_pl_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": max(e["errs"]),
            # one encode launches once per scale: the bench scales' times summed
            "ms": sum(e["ms"][r] for r in resolutions),
            "plain_ms": sum(e["plain_ms"][r] for r in resolutions),
            "bound_ms": sum(e["bound_ms"][r] for r in resolutions), "bound_by": by,
            "ms_by_scale": e["ms"], "plain_ms_by_scale": e["plain_ms"],
            "bound_ms_by_scale": e["bound_ms"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "n": N_FULL,
        }
        if name.startswith("cp_product"):  # the stacked encoding's per-scale calls
            entry["ms_stacked_scales"] = sum(e["ms"][r] for r in stacked_resolutions)
            entry["bound_ms_stacked_scales"] = sum(e["bound_ms"][r] for r in stacked_resolutions)
        entries.append(entry)
    return entries


def stacked_kernel_phase(device):
    """K13/K14 (the stacked fused density head: C=64, nested R=(129, 2049) on
    one (3, 2049, 128) bf16 table, F=16, MLP 32->64->16) and K11/K12 (the
    stacked product with its Jacobian and the (32, 128) block-diagonal basis)
    at N=262,144 and 262,107 against their plain versions on the same
    inputs, then timed: training-mode vsave (and K11's gdsave) equal to the
    plain versions' to the bit, hsave within 1e-3 of its entries, forwards
    within 2e-2 * max|plain|, gradients within 2.5e-2 * max|plain|."""
    from instant_nsr_pl_tpu_torch.ops import cp_mlp
    from instant_nsr_pl_tpu_torch.ops import cp_stacked as cps
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
    from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init

    gen = torch.Generator().manual_seed(SEED + 11)
    cp_spec = CPSpec(64, (129, 2049), 16)
    d_spec = MLPSpec(dim_in=32, dim_out=16, n_neurons=64, n_hidden_layers=1)
    cp_params = cp_init(gen, cp_spec, device)
    d_layers = with_biases(mlp_init(gen, d_spec, device), gen, device)
    rmax, s_count, c, f = 2049, 2, 64, 16
    sc, e, w = s_count * c, s_count * f, 64
    x = torch.rand((N_FULL, 3), generator=gen) * 1.1 - 0.05
    knots = [torch.arange(r, dtype=torch.float32) / (r - 1) for r in cp_spec.resolutions]
    special = torch.cat([torch.tensor([0.0, 1.0, -0.05, 1.05]), *knots])
    x[: special.numel(), 0] = special
    x[: special.numel(), 1] = special.flip(0)
    x[: special.numel(), 2] = special.roll(7)
    x = x.to(device)
    u3 = x.T.contiguous()
    d_dout = torch.randn((N_FULL, 16), generator=gen).to(device)
    denc = torch.randn((e, N_FULL), generator=gen).to(device)
    djac = torch.randn((3, e, N_FULL), generator=gen).to(device)
    ops = cp_mlp.cp_mlp_stacked_operands(cp_params, d_layers, cp_spec, d_spec)
    lines, basis, ws, _ = ops
    table = 3 * rmax * sc  # entries of the fine table
    errs = {k: [] for k in ("cp_mlp_stacked_forward", "cp_mlp_stacked_backward",
                            "cp_jac_stacked_forward", "cp_jac_stacked_backward")}

    def bitwise(name, label, a, b):
        if not torch.equal(a, b):
            frac = float((a != b).float().mean())
            raise AssertionError(f"{name}: residual {label} differs from the plain version's "
                                 f"in {frac:.2e} of its entries")
        print(f"[kernel] {name}: residual {label} equals the plain version's to the bit",
              flush=True)

    for n in (N_RAGGED, N_FULL):  # the timing below reuses the N_FULL arguments
        xn, un = x[:n], u3[:, :n].contiguous()
        tag = f"N={n}"
        # K13: the op (eval), then training mode on the packed operands
        got = cp_mlp.cp_mlp_stacked_forward(cp_params, d_layers, xn, cp_spec, d_spec)
        out, vsave, hsave = cp_mlp.cp_mlp_stacked_launch(ops, xn, cp_spec, d_spec, train=True)
        torch.cuda.synchronize()
        ref, ref_v, ref_h = cp_mlp.cp_mlp_stacked_forward_plain(cp_params, d_layers, xn, cp_spec,
                                                                d_spec, save_residuals=True)
        assert torch.equal(got, out), "K13 eval and training mode disagree"
        errs["cp_mlp_stacked_forward"].append(compare(f"cp_mlp_stacked_forward {tag}", out, ref))
        bitwise(f"cp_mlp_stacked_forward {tag}", "vsave", vsave, ref_v)
        frac = float((hsave != ref_h).float().mean())
        print(f"[kernel] cp_mlp_stacked_forward {tag}: hsave differs from the plain version's in "
              f"{frac:.2e} of its entries", flush=True)
        if frac > 1e-3:
            raise AssertionError("cp_mlp_stacked_forward: residual hsave disagrees")
        compare(f"cp_mlp_stacked_forward {tag} hsave", hsave.float(), ref_h.float())
        # K14 from those residuals
        dout = d_dout[:n].contiguous()
        bwd_args = (xn, vsave, hsave, dout, basis, ws, cp_spec, d_spec)
        got = cp_mlp.cp_mlp_stacked_backward_launch(*bwd_args)
        torch.cuda.synchronize()
        ref = cp_mlp.cp_mlp_stacked_backward_plain(*bwd_args)
        for label, a, b in zip(("d fine table", "d basis", "dW", "db"), got, ref):
            assert a.shape == b.shape, (label, tuple(a.shape), tuple(b.shape))
            errs["cp_mlp_stacked_backward"].append(
                compare(f"cp_mlp_stacked_backward {tag} {label}", a, b, rel=2.5e-2))
        # K11: eval and training mode
        enc_e, jac_e, v_e, g_e = cps.cp_jac_basis_stacked_launch(lines, basis, un, rmax)
        enc, jac, vsave_j, gdsave = cps.cp_jac_basis_stacked_launch(lines, basis, un, rmax,
                                                                    train=True)
        torch.cuda.synchronize()
        assert v_e is None and g_e is None, "K11 eval mode wrote residuals"
        assert torch.equal(enc, enc_e) and torch.equal(jac, jac_e)
        ref_j = cps.cp_jac_basis_stacked_plain(lines, basis, un, rmax, save_residuals=True)
        bitwise(f"cp_jac_stacked_forward {tag}", "vsave", vsave_j, ref_j[2])
        bitwise(f"cp_jac_stacked_forward {tag}", "gdsave", gdsave, ref_j[3])
        for label, a, b in zip(("enc", "jac"), (enc, jac), ref_j[:2]):
            errs["cp_jac_stacked_forward"].append(
                compare(f"cp_jac_stacked_forward {tag} {label}", a, b))
        # K12 from those residuals
        de, dj = denc[:, :n].contiguous(), djac[:, :, :n].contiguous()
        jac_bwd_args = (un, vsave_j, gdsave, de, dj, basis, rmax)
        got = cps.cp_jac_basis_stacked_backward_launch(*jac_bwd_args)
        torch.cuda.synchronize()
        ref = cps.cp_jac_basis_stacked_backward_plain(*jac_bwd_args)
        for label, a, b in zip(("d fine table", "d u", "d basis"), got, ref):
            errs["cp_jac_stacked_backward"].append(
                compare(f"cp_jac_stacked_backward {tag} {label}", a, b, rel=2.5e-2))

    # timing at N_FULL; bounds from the bytes each function must move (inputs
    # read once, outputs written once) and its operations: the interpolation
    # and the products on the CUDA cores (f32), the projections through the
    # basis blocks and the MLP as bf16-operand products
    n = N_FULL
    mlp_bytes = (e + w) * w * 2 + 2 * w * 4
    mlp_macs = _mlp_macs([e, w, 16])
    residual_bytes = n * (3 * sc * 2 + w * 2)
    fwd_bytes = n * (12 + 16 * 4) + table * 2 + sc * f * 2 + mlp_bytes
    timed = {
        "cp_mlp_stacked_forward": (
            lambda: cp_mlp.cp_mlp_stacked_launch(ops, x, cp_spec, d_spec, train=True),
            lambda: cp_mlp.cp_mlp_stacked_forward_plain(cp_params, d_layers, x, cp_spec, d_spec,
                                                        save_residuals=True),
            fwd_bytes + residual_bytes, n * 2 * (sc * f + mlp_macs), n * 2 * 3 * sc),
        "cp_mlp_stacked_backward": (
            lambda: cp_mlp.cp_mlp_stacked_backward_launch(*bwd_args),
            lambda: cp_mlp.cp_mlp_stacked_backward_plain(*bwd_args),
            (n * (12 + 3 * sc * 2 + w * 2 + 16 * 4) + sc * f * 2 + (e + w) * w * 2
             + table * 4 + sc * f * 4 + (e + w) * w * 4 + 2 * w * 4),
            n * 2 * (2 * sc * f + 2 * mlp_macs), n * sc * 8),
        "cp_jac_stacked_forward": (
            lambda: cps.cp_jac_basis_stacked_launch(lines, basis, u3, rmax, train=True),
            lambda: cps.cp_jac_basis_stacked_plain(lines, basis, u3, rmax, save_residuals=True),
            n * (12 + 16 * e + 12 * sc) + table * 2 + sc * f * 2, 0, n * sc * (23 + 8 * f)),
        "cp_jac_stacked_backward": (
            lambda: cps.cp_jac_basis_stacked_backward_launch(*jac_bwd_args),
            lambda: cps.cp_jac_basis_stacked_backward_plain(*jac_bwd_args),
            n * (12 + 12 * sc + 16 * e + 12) + table * 4 + sc * f * 2 + sc * f * 4,
            0, n * sc * (40 + 16 * f)),
    }
    meta = {
        "cp_mlp_stacked_forward": ("cp_mlp_fwd.cu", "instant_nsr_pl_tpu/ops/cp_mlp_pallas.py:531"),
        "cp_mlp_stacked_backward": ("cp_mlp_bwd.cu",
                                    "instant_nsr_pl_tpu/ops/cp_mlp_pallas.py:603"),
        "cp_jac_stacked_forward": ("cp_jac_basis_fwd.cu",
                                   "instant_nsr_pl_tpu/ops/cp_pallas.py:904"),
        "cp_jac_stacked_backward": ("cp_jac_basis_bwd.cu",
                                    "instant_nsr_pl_tpu/ops/cp_pallas.py:952"),
    }
    entries = []
    for name, (kern, plain, n_bytes, bf16_ops, f32_ops) in timed.items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain, reps=5, inner=2)
        bound_ms, bound_by = bound(n_bytes, bf16_ops, f32_ops)
        entry = {
            "name": name, "route": "cuda", "source": f"instant_nsr_pl_tpu_torch/csrc/{meta[name][0]}",
            "replaces": meta[name][1], "launches": 0, "max_abs_err": max(errs[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "n": N_FULL,
        }
        if name == "cp_mlp_stacked_forward":
            entry["ms_eval"] = time_ms(lambda: cp_mlp.cp_mlp_stacked_launch(ops, x, cp_spec, d_spec))
        elif name == "cp_jac_stacked_forward":
            entry["ms_eval"] = time_ms(lambda: cps.cp_jac_basis_stacked_launch(lines, basis, u3, rmax))
        extra = f", {entry['ms_eval']:.4f} ms eval" if "ms_eval" in entry else ""
        print(f"[kernel] {name}: {ms:.4f} ms{extra} (plain {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by}) at N={n}", flush=True)
        entries.append(entry)
    return entries


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


def train_phase(device, smi, config=BENCH_CONFIG, stacked=False):
    """The bench NeRF (or, with ``stacked``, the stacked NeRF: K13/K14 for
    K1/K2) trained through NeRFSystem.train_step for TRAIN_STEPS steps."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays

    tag = "train-stacked" if stacked else "train"
    cfg = config_from_dict(bench_config(config))
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("fit")
    system = systems.make(cfg.system.name, cfg)  # on CUDA by default
    system.setup_data(dm.train)
    val = dataset_device_arrays(dm.val, device)
    state = system.init_state(seed=SEED)
    model, params = system.model, state["params"]
    ewn = model.geometry.encoding_with_network
    assert ewn.fused and ewn.encoding.encoding.stack_scales == stacked
    n_rays = system.active_num_rays
    assert n_rays == int(cfg.model.max_train_num_rays), n_rays
    assert system.train_capacity == int(cfg.model.train_num_samples), system.train_capacity
    assert state["generator"].device.type == device.type

    # the untrained model against the grid its first (warmup) update gives
    # (a generator of its own: the run's draws stay those of the seed)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    occ0 = model.update_occupancy(params, state["occ"], gen, warmup=True)
    untrained = system.evaluate_image({"params": params, "occ": occ0}, 0, data=val)
    print(f"[{tag}] untrained val view: PSNR {untrained['psnr']:.3f} dB", flush=True)

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
    print(f"[{tag}] gradient check: loss {float(loss.detach()):.5f}, {len(named_leaves(params))} "
          "parameter tensors with finite, non-zero gradients", flush=True)
    state["optimizer"].zero_grad()

    # the main path: TRAIN_STEPS steps, launch counters read around each
    density = "cp_mlp_stacked" if stacked else "cp_mlp"
    counters = {f"{density}_forward": getattr(cp_mlp, f"{density}_forward"),
                f"{density}_backward": getattr(cp_mlp, f"{density}_backward"),
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
        if i % system.grid_update_every == 0 and delta[f"{density}_forward"] < 2:
            raise AssertionError(f"step {i}: the grid update did not run {density}: {delta}")
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
    print(f"[{tag}] {TRAIN_STEPS} steps in {t_end - t0:.2f} s; launches {totals}; one step "
          f"{per_step[1]}, a grid-update step {per_step[16]}", flush=True)
    for i in sorted({0, 1, 15, 16, 50, 100, 200, TRAIN_STEPS - 1} & set(range(TRAIN_STEPS))):
        print(f"[{tag}] step {i}: loss {losses[i]:.5f} psnr {psnrs[i]:.3f}", flush=True)
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    p_first, p_last = float(np.mean(psnrs[:20])), float(np.mean(psnrs[-20:]))
    print(f"[{tag}] mean loss, first 20 steps {first:.5f}, last 20 {last:.5f}; mean training "
          f"PSNR {p_first:.3f} -> {p_last:.3f} dB; occupied cells {occupied_warm} after the "
          f"warmup update, {occupied} of {grid.binary.numel()} at the end", flush=True)
    assert np.isfinite(losses).all()
    assert last < first, "the loss did not fall"
    assert p_last > p_first, "the training PSNR did not rise"
    assert 0 < occupied < occupied_warm, "the grid did not prune"
    trained = system.evaluate_image(state, 0, data=val)
    print(f"[{tag}] val view after {TRAIN_STEPS} steps: PSNR {trained['psnr']:.3f} dB, SSIM "
          f"{trained['ssim']:.4f} (untrained {untrained['psnr']:.3f} dB)", flush=True)
    assert trained["psnr"] >= untrained["psnr"] + 3.0, "training gained less than 3 dB"
    seen = system.evaluate_image(state, 0)
    print(f"[{tag}] train view 0 after {TRAIN_STEPS} steps: PSNR {seen['psnr']:.3f} dB, SSIM "
          f"{seen['ssim']:.4f}", flush=True)
    print(f"[{tag}] warm: {rays_per_s:.0f} rays/s, {warm_s / 100 * 1e3:.2f} ms per step over the "
          f"last 100 steps ({smi})", flush=True)
    return per_step[1], totals, rays_per_s, warm_s / 100


def neus_system(device, grad_type="analytic", lambda_curvature=0.0, config=NEUS_CONFIG):
    """The bench NeuS (bench.py build_neus_system("cp")), or the stacked one
    with ``NEUS_STACKED_CONFIG``, on CUDA, set up on the train split, and its
    val split's arrays."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays

    raw = bench_config(config)
    raw["model"]["geometry"]["grad_type"] = grad_type
    raw["system"]["loss"]["lambda_curvature"] = lambda_curvature
    cfg = config_from_dict(raw)
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("fit")
    system = systems.make(cfg.system.name, cfg)  # on CUDA by default
    assert system.device.type == device.type
    system.setup_data(dm.train)
    return system, dataset_device_arrays(dm.val, device)


def neus_counters():
    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp
    from instant_nsr_pl_tpu_torch.ops import cp_stacked as cps
    from instant_nsr_pl_tpu_torch.ops import sh_mlp

    return {"sh_mlp_forward": sh_mlp.sh_mlp_forward, "sh_mlp_backward": sh_mlp.sh_mlp_backward,
            "cp_product_forward": cpp.cp_product, "cp_product_backward": cpp.cp_product_backward,
            "cp_jac_basis_forward": cpp.cp_product_jac_basis,
            "cp_jac_basis_backward": cpp.cp_product_jac_basis_backward,
            "cp_jac_stacked_forward": cps.cp_jac_basis_stacked,
            "cp_jac_stacked_backward": cps.cp_jac_basis_stacked_backward}


def _batch(system, gen):
    n_rays = system.active_num_rays
    rays_o, rays_d, rgb, fg = system._sample_rays(system.data, gen, n_rays)
    bg = system._background_color(gen, n_rays, train=True)
    rgb = rgb * fg[:, None] + bg * (1.0 - fg[:, None])
    return {"rays_o": rays_o, "rays_d": rays_d, "rgb": rgb, "fg_mask": fg, "background_color": bg}


def _grads(params, step, exempt=()):
    """Every parameter tensor's gradient finite, and non-zero unless its key
    is one of ``exempt`` (then it must be zero)."""
    from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves

    for key, t in named_leaves(params):
        g = t.grad
        if g is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"step {step}: parameter {key}: gradient missing or non-finite")
        nonzero = bool((g != 0).any())
        if nonzero == any(key.startswith(e) for e in exempt):
            raise AssertionError(f"step {step}: parameter {key}: gradient "
                                 f"{'non-zero' if nonzero else 'zero'}")
    return len(named_leaves(params))


def neus_train_phase(device, smi, config=NEUS_CONFIG, stacked=False):
    """The bench NeuS (or, with ``stacked``, the stacked NeuS: K11/K12 for
    K9/K10) trained through NeuSSystem.train_step for NEUS_STEPS steps
    (8,192 rays and 262,144 packed samples per step)."""
    tag = "neus-stacked" if stacked else "neus"
    jac = "cp_jac_stacked" if stacked else "cp_jac_basis"
    system, val = neus_system(device, config=config)
    state = system.init_state(seed=SEED)
    model, params = system.model, state["params"]
    geo = model.geometry
    assert geo.use_jac and geo.encoding.encoding.grad_mode == "fast" and model.texture.fused
    assert geo.encoding.encoding.stack_scales == stacked
    assert system.train_capacity == N_FULL, system.train_capacity

    # the untrained model against the grid its first (warmup) update gives
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    occ0 = model.update_occupancy(params, state["occ"], gen, warmup=True)
    untrained = system.evaluate_image({"params": params, "occ": occ0}, 0, data=val)
    print(f"[{tag}] untrained val view: PSNR {untrained['psnr']:.3f} dB", flush=True)

    # before the first step: a backward, finite gradients everywhere, zero
    # only on the CP tables and bases (the sphere init's first layer is zero
    # beyond the xyz rows, so d out / d enc = 0)
    cp_keys = ("geometry.encoding.",)
    loss, _ = system.loss_fn(params, occ0, _batch(system, gen), gen, 0)
    assert loss.grad_fn is not None, "the loss has no backward"
    loss.backward()
    n_leaves = _grads(params, 0, exempt=cp_keys)
    state["optimizer"].zero_grad()
    print(f"[{tag}] gradient check before step 0: loss {float(loss.detach()):.5f}, {n_leaves} "
          "parameter tensors finite, non-zero but the CP lines and bases (zero by the sphere "
          "init)", flush=True)

    counters = neus_counters()
    for c in counters.values():
        c.launches = 0
    losses, psnrs, inv_s, live, per_step = [], [], [], [], []
    n_warm = min(100, NEUS_STEPS // 2)
    warm_from = NEUS_STEPS - n_warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_warm = None
    for i in range(NEUS_STEPS):
        if i == warm_from:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        before = {k: c.launches for k, c in counters.items()}
        state, metrics = system.train_step(state)
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        for k in ("sh_mlp_forward", "sh_mlp_backward", f"{jac}_forward", f"{jac}_backward"):
            if delta[k] < 1:
                raise AssertionError(f"{tag} step {i}: {k} was not launched: {delta}")
        if i % system.grid_update_every == 0 and delta["cp_product_forward"] < 2:
            raise AssertionError(f"{tag} step {i}: the grid update did not run K5: {delta}")
        if i == 1:
            # after the first update the tables and bases get gradients too
            loss, _ = system.loss_fn(state["params"], state["occ"], _batch(system, gen), gen, i)
            loss.backward()
            _grads(state["params"], i)
            state["optimizer"].zero_grad()
            print(f"[{tag}] gradient check after the first update: every parameter tensor "
                  "finite and non-zero", flush=True)
        per_step.append(delta)
        losses.append(metrics["train/loss"])
        psnrs.append(metrics["train/psnr"])
        inv_s.append(metrics["train/inv_s"])
        live.append(metrics["train/num_samples"])
        if i == 0:
            occupied_warm = int(state["occ"]["grid"].binary.sum())
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    totals = {k: c.launches for k, c in counters.items()}
    losses = [float(v) for v in losses]
    psnrs = [float(v) for v in psnrs]
    inv_s = [float(v) for v in inv_s]
    live = [int(v) for v in live]
    grid = state["occ"]["grid"]
    occupied = int(grid.binary.sum())
    n_rays = system.active_num_rays
    warm_s = t_end - t_warm
    rays_per_s = n_warm * n_rays / warm_s
    print(f"[{tag}] {NEUS_STEPS} steps in {t_end - t0:.2f} s; launches {totals}; one step "
          f"{per_step[1]}, a grid-update step {per_step[16]}", flush=True)
    for i in sorted({0, 1, 15, 16, 50, 100, 200, 300, 500, NEUS_STEPS - 1}
                    & set(range(NEUS_STEPS))):
        print(f"[{tag}] step {i}: loss {losses[i]:.5f} psnr {psnrs[i]:.3f} inv_s {inv_s[i]:.3f} "
              f"live samples {live[i]} (capacity {system.train_capacity})", flush=True)
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    p_first, p_last = float(np.mean(psnrs[:20])), float(np.mean(psnrs[-20:]))
    print(f"[{tag}] mean loss, first 20 steps {first:.5f}, last 20 {last:.5f}; mean training "
          f"PSNR {p_first:.3f} -> {p_last:.3f} dB; inv_s {inv_s[0]:.3f} -> {inv_s[-1]:.3f}; "
          f"occupied cells {occupied_warm} after the warmup update, {occupied} of "
          f"{grid.binary.numel()} at the end", flush=True)
    assert np.isfinite(losses).all()
    assert last < first, "the loss did not fall"
    assert p_last > p_first, "the training PSNR did not rise"
    assert inv_s[-1] > math.exp(3.0), "inv_s did not rise above its initial e^3"
    assert 0 < occupied < grid.binary.numel(), "the grid did not leave its all-occupied state"
    trained = system.evaluate_image(state, 0, data=val)
    print(f"[{tag}] val view after {NEUS_STEPS} steps: PSNR {trained['psnr']:.3f} dB, SSIM "
          f"{trained['ssim']:.4f} (untrained {untrained['psnr']:.3f} dB)", flush=True)
    assert trained["psnr"] >= untrained["psnr"] + 3.0, "training gained less than 3 dB"
    print(f"[{tag}] warm: {rays_per_s:.0f} rays/s, {warm_s / n_warm * 1e3:.2f} ms per step over "
          f"the last {n_warm} steps ({smi})", flush=True)
    return system, state, val, per_step[1], totals, rays_per_s


def neus_render_phase(device, system, state, val, smi):
    """One 256x256 val view of the trained NeuS through evaluate_image (the
    counters read around it: K9, or K11 for the stacked NeuS, in eval mode,
    K3), again warm through render_image, and one composited 4,096-ray chunk
    from the kernels on the card against the same chunk from the plain
    versions on the CPU."""
    from instant_nsr_pl_tpu_torch.ops.ray import get_rays

    stacked = system.model.geometry.encoding.encoding.stack_scales
    tag = "neus-stacked-render" if stacked else "neus-render"

    counters = neus_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = system.evaluate_image(state, 0, data=val)
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    n_rays = system.w * system.h
    stats = system.last_render_stats
    imgs = res["images"]
    print(f"[{tag}] val view: {view_s:.3f} s, {n_rays / view_s:.0f} rays/s (first view), "
          f"PSNR {res['psnr']:.3f} dB, {stats}, launches {launches}", flush=True)
    assert stats["rays_kept"] == n_rays, stats
    for k in ("comp_rgb", "comp_normal", "opacity", "depth"):
        assert np.isfinite(imgs[k]).all(), k
    chunks = -(-n_rays // system.eval_chunk_rays)
    if stacked:  # one per chunk
        assert launches["cp_jac_stacked_forward"] >= chunks, launches
    else:  # one per scale and chunk
        assert launches["cp_jac_basis_forward"] >= 2 * chunks, launches
    assert launches["sh_mlp_forward"] >= chunks, launches
    assert launches["cp_jac_basis_backward"] == launches["cp_jac_stacked_backward"] == 0, launches
    assert launches["sh_mlp_backward"] == 0, launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.render_image(state, 0, data=val)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"[{tag}] val view again: {warm_s:.3f} s, {n_rays / warm_s:.0f} rays/s ({smi})",
          flush=True)

    # one 4,096-ray chunk (the image's middle rows): kernels on the card,
    # plain versions on the CPU
    ro, rd = get_rays(val["directions"].reshape(-1, 3), val["c2w"][0])
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    sl = slice(max(0, n_rays // 2 - 2048), n_rays // 2 + 2048)
    ro, rd = ro[sl].contiguous(), rd[sl].contiguous()
    outs = []
    for dev in (device, torch.device("cpu")):
        grid = state["occ"]["grid"]
        occ = {"grid": type(grid)(*[t.to(dev) for t in grid])}
        outs.append(system.model.forward(
            _to(state["params"], dev), occ, ro.to(dev), rd.to(dev),
            background_color=torch.ones(3, device=dev), capacity=N_FULL, step=state["step"]))
    cuda, cpu = outs
    live = int(cpu["num_samples"])
    assert live > 0 and int(cuda["num_samples"]) == live, "the two marches differ"
    errs = {}
    for k in ("comp_rgb", "comp_rgb_full", "comp_normal"):
        errs[k] = float((cuda[k].cpu() - cpu[k]).abs().max())
        tol = 2e-2 * float(cpu[k].abs().max())
        print(f"[{tag}] middle chunk: {live} live samples, max|d {k}| kernels vs plain = "
              f"{errs[k]:.3e} (limit {tol:.3e})", flush=True)
        if not errs[k] <= tol:
            raise AssertionError(f"composited chunk {k}: kernels and plain versions disagree")
    return launches, n_rays / view_s, n_rays / warm_s


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.detach().to(device)


def neus_fd_phase(device):
    """The bench NeuS with geometry.grad_type: finite_difference (and the
    curvature loss on its Laplacian) for FD_STEPS steps: K5 and K6 run the
    stencil's SDF on every step, all gradients are finite, the tables get a
    gradient after the first update, the loss stays finite."""
    system, _ = neus_system(device, grad_type="finite_difference", lambda_curvature=5e-4)
    state = system.init_state(seed=SEED)
    assert system.model.geometry.grad_type == "finite_difference"
    counters = neus_counters()
    for c in counters.values():
        c.launches = 0
    losses, per_step = [], []
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FD_STEPS):
        before = {k: c.launches for k, c in counters.items()}
        state, metrics = system.train_step(state)
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        if delta["cp_product_forward"] < 1 or delta["cp_product_backward"] < 1:
            raise AssertionError(f"fd step {i}: K5/K6 not launched: {delta}")
        if delta["cp_jac_basis_forward"] or delta["cp_jac_basis_backward"]:
            raise AssertionError(f"fd step {i}: the jac kernels ran: {delta}")
        per_step.append(delta)
        losses.append(float(metrics["train/loss"]))
        if i == 0:
            loss, _ = system.loss_fn(state["params"], state["occ"], _batch(system, gen), gen, 1)
            loss.backward()
            n_leaves = _grads(state["params"], 1)
            state["optimizer"].zero_grad()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = {k: c.launches for k, c in counters.items()}
    print(f"[neus-fd] {FD_STEPS} steps in {wall:.2f} s; launches {totals}; one step "
          f"{per_step[1]}; {n_leaves} parameter tensors with finite, non-zero gradients after "
          f"the first update; loss {losses[0]:.5f} -> {losses[-1]:.5f}", flush=True)
    assert np.isfinite(losses).all(), "the loss went non-finite"
    return per_step[1], totals


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

    entries = kernel_phase(device) + cp_kernel_phase(device) + stacked_kernel_phase(device)
    render_launches, rays_per_s, warm_rays_per_s = render_phase(device)
    print(f"[render] rays/s: {rays_per_s:.0f} first view, {warm_rays_per_s:.0f} warm ({smi})",
          flush=True)
    step_launches, run_launches, train_rays_per_s, s_per_step = train_phase(device, smi)
    print(f"[train] rays/s: {train_rays_per_s:.0f} warm, {s_per_step:.4f} s per step ({smi})",
          flush=True)
    st_step, st_run, st_rays_per_s, st_s_per_step = train_phase(device, smi, NERF_STACKED_CONFIG,
                                                                stacked=True)
    print(f"[train-stacked] rays/s: {st_rays_per_s:.0f} warm, {st_s_per_step:.4f} s per step "
          f"({smi})", flush=True)
    system, state, val, neus_step, neus_run, neus_rays_per_s = neus_train_phase(device, smi)
    neus_view, neus_view_first, neus_view_warm = neus_render_phase(device, system, state, val, smi)
    del system, state, val
    torch.cuda.empty_cache()
    fd_step, fd_run = neus_fd_phase(device)
    print(f"[neus] rays/s: {neus_rays_per_s:.0f} warm training; view {neus_view_first:.0f} first, "
          f"{neus_view_warm:.0f} warm ({smi})", flush=True)
    torch.cuda.empty_cache()
    system, state, val, ns_step, ns_run, ns_rays_per_s = neus_train_phase(
        device, smi, NEUS_STACKED_CONFIG, stacked=True)
    ns_view, ns_view_first, ns_view_warm = neus_render_phase(device, system, state, val, smi)
    del system, state, val
    print(f"[neus-stacked] rays/s: {ns_rays_per_s:.0f} warm training; view {ns_view_first:.0f} "
          f"first, {ns_view_warm:.0f} warm ({smi})", flush=True)
    # launches: counted in the run of the path that runs the kernel (the NeRF
    # training runs for K1/K2 and K13/K14, the NeuS training runs for
    # K3-K5/K9/K10 and K11/K12, the finite-difference run for K6), with the
    # per-step counts of each path
    paths = {"nerf_train": (step_launches, run_launches), "nerf_stacked_train": (st_step, st_run),
             "neus_train": (neus_step, neus_run), "neus_fd": (fd_step, fd_run),
             "neus_stacked_train": (ns_step, ns_run)}
    views = {"nerf_view": render_launches, "neus_view": neus_view, "neus_stacked_view": ns_view}
    for e in entries:
        name = e["name"]
        for path, (per_step, run) in paths.items():
            if name in run:
                e[f"launches_{path}_step"] = per_step[name]
                e[f"launches_{path}_run"] = run[name]
        for path, view in views.items():
            if name in view:
                e[f"launches_{path}"] = view[name]
        main_path = ("nerf_stacked_train" if name.startswith("cp_mlp_stacked")
                     else "nerf_train" if name.startswith("cp_mlp")
                     else "neus_stacked_train" if name.startswith("cp_jac_stacked")
                     else "neus_fd" if name == "cp_product_backward" else "neus_train")
        e["launches"] = e[f"launches_{main_path}_run"]
        e["launches_path"] = main_path
        if e["launches"] < 1:
            raise AssertionError(f"{name}: not launched on its main path ({main_path})")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
