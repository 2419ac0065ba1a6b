"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain versions: the bench NeRF and the bench NeuS, rendered and trained, the
raw-product NeuS trained, tested, predicted and exported as a mesh, the
hash-grid NeRF trained (and the repo's ``configs/nerf-synthetic.yaml``
trained, tested and exported through the launcher), NeuS on the hash grid
(the repo's ``configs/neus-synthetic.yaml`` through the launcher, and its
progressive-band variant), the ``cp_big`` shapes, the gather / scatter
probes, the Blender and DTU configs on data read from disk
(``data80/blender`` and a DTU-layout export), the unbounded configs (also on
a JPEG capture), the VM NeRF (``configs/nerf-vm-synthetic.yaml``), and
``configs/nerf-blender.yaml`` trained data-parallel through the launcher's
``--devices 2``; every mesh marches on the card.

    python3 chip_smoke.py [--parent DIR]

Phases (each raises on failure; any failure exits non-zero before the result
lines are printed):

1. environment: torch version, card name and power limit; TF32 off;
2. build: every ``instant_nsr_pl_tpu_torch/csrc/*.cu`` with nvcc (parallel);
3. kernels at the bench NeRF's full width (K1/K2 fused density forward and
   backward: CP C=64, R=(128, 2048), F=16, MLP 32->64->16; K3/K4 fused
   radiance forward and backward: SH degree 4, 16 features, MLP
   32->64->64->3), at N=262,144 and a ragged N=262,107, each against its
   plain PyTorch version on the same inputs: forwards within 2e-2 *
   max|plain| (eval mode equal to training mode to the bit), backwards (fed
   the same training-mode residuals) within
   2.5e-2 * max|plain| per gradient tensor, the JAX gradient tests'
   tolerance; then timed with CUDA events (median of 20 batches of 10
   back-to-back calls, after warm-up);
4. CP kernels (K5/K6 the CP product, K7/K8 the product with its Jacobian,
   K9/K10 the product with its Jacobian and the basis projection) at the
   bench NeuS encoding (C=64, F=16) for both scales, R=128 and 2048, at
   N=262,144 and 262,107: training-mode residuals and K5's prod equal to the
   plain versions' to the bit, forwards within 2e-2 and gradients within
   2.5e-2 of max|plain|, K10's d basis equal to the bit across two identical
   calls; timed as above (K5, K7 and K9 in training and eval mode);
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
   steps: K5/K6 on every step, finite gradients, a finite loss (the whole
   trajectory printed); the last step's K6 launches (two at N and two at 6N,
   the stencil, one per scale) recorded, each held against its plain version
   on its own operands within 2.5e-2 * max|plain|, and timed;
10. the stacked NeuS (``neus-cp-stacked-synthetic.yaml``) trained and
   rendered as in 7 and 8, with K11/K12 in place of K9/K10 and K5 at R=129
   and 2049 in the grid updates;
11. the raw-product NeuS (``neus-cp-raw-synthetic.yaml``: the bench NeuS with
   ``n_features: 0``, E = 131 SDF inputs) trained and rendered as in 7 and 8,
   with K7/K8 in place of K9/K10; then, on the trained model, the Trainer's
   ``test`` (the four test views with PNGs and sidecars, test/psnr, then the
   mesh), ``predict`` (the eight train-camera views) and ``export`` (the
   128^3 two-stage marching pass: K5 in the level grid, K7 in eval mode for
   the vertex colours, no backward; a non-empty mesh with valid indices and
   colours in [0, 1]; timed by stage; one chunk of vertex colours against the
   plain versions on the CPU within 2e-2), each with the launch counters read
   around it; and the port's extraction of the scene's own sphere SDF, every
   vertex within one voxel of a sphere surface;
12. HG1/HG2 (``csrc/hashgrid_{fwd,bwd}.cu``, the hash encoding and its
   table gradient, on the row-major (T, F) table) at the bench hash shape
   (16 levels, F=2, 2^19 rows) at N=262,144 and 262,107, with and without a
   level mask: HG1 within rtol 1e-5 of its plain version (equal to the bit
   in practice; the share of equal entries is printed), HG2's table
   gradient within 1e-5 x max|plain| per level (float32 atomics), its
   position gradient within 1e-4, on uniform and on ray-ordered samples
   (where HG2 merges equal rows); timed, with bounds by compulsory bytes and
   by the hashed levels' 32-byte sectors, beside the gradient from
   precomputed taps by one ``index_add_`` per feature (``composed_ms``);
   then HG3/HG4 (``csrc/hashgrid_jac_{fwd,bwd}.cu``, the encoding with its
   position Jacobian and its backward from both cotangents) at
   ``configs/neus-synthetic.yaml``'s grid (12 levels, F=2, 2^18 rows) at
   N=65,536 and 262,144, uniform and ray-ordered, without and with a
   ProgressiveBandHashGrid mask of 5 levels: HG3's features equal to HG1's
   to the bit, its Jacobian within 2e-2 x max|plain|, HG4 within the HG2
   limits against the float64 sum of the plain version's updates, its d x
   the same bits in two calls; timed (and as device time) beside their
   bounds (bytes, sectors) and HG4 beside its updates by ``index_add_``;
13. the ``bench.py --encoding cp_big`` instantiations (C=128, R=(64, 512,
   4096), F=16): K1/K2 with the 48->64->16 head, K5-K10 per scale, against
   their plain versions as in 3-4, timed; then the cp_big NeRF, NeuS, raw
   NeuS and finite-difference NeuS built for the card and trained
   CP_BIG_STEPS steps each (their kernels launched on every step), and a CP
   width without kernels refused when its model is built;
14. the probes P1a-P1g and P2 (``tools/microbench_gather.py``,
   ``csrc/gather_probes.cu``) at M=2^18 against numpy and their plain
   versions; P1f and P1g with every index on one row, P1a unroll 8, P1b and
   P1e on ragged counts against their plain versions; P2 a / b / c at one
   chunk, five chunks, every index on one row, the first and last rows
   only and rows of one 4-bank group (P2a / P2b to the bit against their
   emulated order, P2c to the bit against numpy); then the probe script's own run at the JAX scripts' sizes (each
   probe and its library call timed warm and with a cold L2) with the
   launch counters read around it;
15. the hash NeRF (``instant_nsr_pl_tpu_torch/configs/nerf-hash-
   synthetic.yaml``, ``bench.py build_system("hash")``) trained as in 6, with
   HG1/HG2 in place of K1/K2 (HG1 also in every grid update);
16. the repo's ``configs/nerf-synthetic.yaml``, unmodified, through the
   port's launcher: ``--train trainer.max_steps=LAUNCHER_STEPS`` (dynamic
   ray sampling, MultiStepLR, the automatic 8-view test and mesh), then
   ``--export``: test/psnr, a non-empty mesh with valid indices, HG1 in the
   export's level grid; then the repo's ``configs/neus-synthetic.yaml``,
   unmodified (NeuS on the hash grid with analytic gradients, dynamic ray
   sampling), through the launcher: ``--train`` for LAUNCHER_STEPS of its
   2,000 steps with HG3, HG4, K3 and K4 on every step (counted around each
   step), the loss falling, inv_s rising, the val views 3 dB above the
   untrained model's, the automatic test and mesh, then ``--export`` timed by
   stage (a non-empty mesh with valid indices, HG1 in the level grid, HG3 in
   the vertex colours); the last step's HG3 / HG4 checked and timed on their
   own operands; then the same config with neuralangelo-dtu-wmask.yaml's
   geometry over it (ProgressiveBandHashGrid, finite differences, the
   progressive eps) for BAND_STEPS steps: every HG1 / HG2 launch carries
   the step's level mask, the eps follows the level, the loss stays finite;
17. slice 8, the Blender and DTU loaders (``datasets/{blender,dtu}.py``, PNGs
   read by ``utils/image_io.py``) through the launcher, each run's split
   loads (decode, resize), warm training rate and mesh export by stage
   printed: ``configs/nerf-blender.yaml`` on ``data80/blender`` (800x800, 80
   views; HG1, HG2, K3 and K4 on every step of LAUNCHER_STEPS, then the
   4-view test, the mesh and ``--export`` with HG1 in its level grid and no
   backward), ``configs/neus-blender.yaml`` on the same data (HG3, HG4, K3
   and K4 on every step), every run's isosurface cut to ISO_CUT^3, each with
   test/psnr at least 3 dB above the untrained model's and the last step's
   HG1-HG4 / K3 / K4 launches held against their plain versions on their own
   operands; ``tools/make_synthetic_data.py``'s DTU layout of the scene
   (DTU_VIEWS views at DTU_SIZE^2) with ``configs/neus-dtu-wmask.yaml`` on it
   (img_downscale 2; HG3 and HG4 on every step, its float32 radiance head
   not K3 / K4's; the val split, the training images, 3 dB above the
   untrained model's; DTU_TEST_VIEWS of its 60 test frames; a mesh and its
   chamfer against the scene's analytic surface) and
   ``configs/neuralangelo-dtu-wmask.yaml`` on it for BAND_STEPS steps, each
   HG1 / HG2 launch's level mask and the eps checked per step as in 16;
18. slice 9, unbounded scenes (sphere contraction, cone-angle stepping, the
   256^3 contracted grid, the learned background; ``datasets/colmap.py``)
   through the launcher as in 17: ``tools/make_synthetic_data.py``'s COLMAP
   layout of the scene (COLMAP_VIEWS views at COLMAP_SIZE^2, one PINHOLE
   camera, PNG, the background a textured sphere of radius COLMAP_BACKDROP)
   with ``configs/nerf-colmap.yaml`` (img_downscale 4; HG1, HG2,
   K3 and K4 on every step; then ``--export`` at threshold 5.0) and
   ``configs/neus-colmap.yaml`` on it (HG3 / HG4 for the foreground SDF, HG1
   / HG2 for the background density on every step), and
   ``configs/neus-dtu.yaml`` (DTU without masks, with the background) on the
   DTU export of 17; the up direction from the cameras
   (``dataset.up_est_method=camera``: the scene has no ground plane for the
   RANSAC of ``ground``), the test trajectory cut to DTU_TEST_VIEWS frames;
   each with the val split 3 dB above the untrained model's, the warm
   training rate, the share of the packed foreground and background samples
   that are live, the seconds and peak memory of the grid warmup updates
   (every cell of the 256^3 grid through the density network), a non-empty
   mesh and, for NeuS, the foreground SDF's range over the AABB and the
   share of a val view's pixels that the foreground covers;
19. slice 10, the VM encoding: VM1 / VM2 (``csrc/vm_{fwd,bwd}.cu``) at the
   VM NeRF's width (C=16, planes 512^2 and 256^2, lines 2048, 2 scales), N =
   262,144 and 262,107 uniform points with samples at u = 0 and 1, against
   their plain versions (VM1 equal to the bit, VM2's table gradients within
   1e-5 x max|ref| per table of a float64 sum, d x within 1e-4 and equal to
   the bit in a second launch), timed beside their bounds, the plain
   versions and the composed yardsticks; then
   ``instant_nsr_pl_tpu_torch/configs/nerf-vm-synthetic.yaml`` trained as in
   6 with VM1 / VM2 in place of K1 / K2 (every VM1 / VM2 launch of the last
   step held against its plain version on its own operands and timed on
   them, CUDA events and device ms, beside the bounds on those operands;
   steps 81-90 under torch.profiler: the step's device ms, busy share and
   device launches),
   the val view 3 dB above the untrained render, and its mesh at 128^3 with
   the launch counters set to 0 just before it and read just after (VM1 in
   the level grids, MT1 / MT2 marching on the card);
20. marching tetrahedra on the card (``csrc/marching_tet.cu``): every export
   and test mesh of phases 11, 16-18 and 21 marches through MT1 / MT2 (their
   launches counted around each phase, the export stage lines say "(card)");
   the ``neus-blender`` model of phase 16 exported again uncut, at the
   config's 512^3, timed by stage, its fine level grid kept; then MT1 / MT2
   against the numpy twin, which ran in processes of their own (``--twin``)
   beside the card's phases, on a sphere SDF at 128^3, 256^3 and 512^3, on
   that NeuS grid and on the VM NeRF's level grid at 256^3: faces equal,
   vertices within 1 ulp (the count that differ printed), the card's warm
   milliseconds against the twin's seconds, the device ms by kernel and the
   pass's stages (an event after each), MT1 / MT2 alone timed at 512^3 beside
   their bounds (this design's and the first design's), and that mesh, the
   run's largest, written by ``save_obj`` (``utils/obj_writer.cc``) and by
   Python's formatting: the same bytes, both timed; given ``--parent DIR``,
   ``tools/mt_bench.py`` on the spheres and the NeuS grid from DIR and from
   this checkout in turns (parent, change, change, parent);
21. slice 14, JPEG: every JPEG fixture of ``tests/fixtures/jpeg/`` through
   ``read_jpeg`` (``utils/jpeg_decode.cc``, g++ on this host) against the
   sha256, shape and mode of PIL's array (``digests.json``; the card has no
   PIL), the decode rate in MP/s (the 1024x768 fixture, the capture
   serially and on the loader's threads); the JPEG COLMAP capture there (24
   views, JPEG images and masks) through ``datasets.make("colmap", ...)``,
   its images, masks and directions against the JAX loader's digests, its
   load seconds; ``configs/nerf-colmap.yaml`` on that capture through the
   launcher as in 18 (``dataset.*``, the steps and the mesh resolution cut,
   the model unmodified); and on that run's last training step's
   compositing operands the per-ray sum's custom VJP (``ops/rendering.py``
   ``segment_sum_sorted``) against autograd through the same forward: the
   forward to the bit, the gradients within 1e-6 x max|grad|, both
   segment-sum backwards timed
   with CUDA events (back to back, and one call queued behind a spin kernel
   for the device time); on the same step's ``render_weight_from_density``
   operands the segmented prefix sum's backward (``SegmentedInclusiveCumsum``,
   gathers only) against autograd through the same float64 forward, for the
   weights and for the distortion loss on those samples: the forwards to the
   bit, the gradients within 1e-6 x max|grad|, both backwards timed;
22. slice 15, data parallel: ``configs/nerf-blender.yaml`` at full width on
   ``data80/blender`` through the launcher with ``--devices 2`` (NCCL on two
   cards, else both ranks on this card over gloo; the world size, backend
   and card count printed) for DP_STEPS steps, each rank observed by
   ``tools/dp_check.py`` ``observe``: HG1 / HG2 / K3 / K4 launched on every
   step of every rank (the counts read in each rank and gathered to rank 0,
   the emulation's launches left out), the ranks' batches different at every
   step, the grid, parameters, AdamW moments, extra state and generator
   equal to the bit across the ranks (sha256) after the first grid update
   and at the end, step DP_EMULATE's mean gradients and parameter updates within
   2.5e-2 of rank 0's single-rank emulation's largest per tensor (every
   rank's batch rebuilt from the step's seed and equal to the one that rank
   drew, its gradients averaged, then AdamW), the loss falling, the val
   views 3 dB above the untrained model's, the warm per-rank step wall and
   the gradient all-reduce's share (CUDA events), rank 0's mesh marched on
   the card; then DP_WS1_STEPS steps at world size 1 over NCCL;
23. one JSON line ``{"kernels": [...]}`` and the card's name and power limit.
   The entries of the redesigned kernels (the backwards K2, K14, cp_big's K2,
   K4, K6, cp_big's K6, K8, cp_big's K8, K10, K12, cp_big's K10, HG2, HG4,
   VM2; the forwards K1, K13, cp_big's K1, K3, K5, cp_big's K5, K9, cp_big's
   K9, K11, HG1, HG3 and VM1) also carry ptxas' registers and spills of the loaded
   build (this run's, or the log an earlier build left beside its library in
   ``_build/``), their shared memory and blocks per SM (the launch plan;
   HG1-HG4's from their registers and shared memory; the tiled forwards for the
   training mode, and ``ptxas_eval`` etc. for the eval mode),
   ``ms_ray_ordered`` (the kernel timed on the operands of the last step of
   the bench training runs, the raw NeuS's for K8, the finite-difference
   NeuS's for K5 and K6, the NeuS hash launcher's for HG3 and HG4,
   ray-ordered samples, every launch of the step: K8,
   K9 and K10 once per scale, K5 and K6 four times; the forwards'
   training-mode launches, K5, K9 and K11 each held against its plain
   version on them; K5 and K6 also the size of each launch), for the
   backwards ``device_ms`` (the
   device time of a call under torch.profiler, without the host's share)
   and ``composed_ms`` (their products as a chain of ``torch.matmul`` calls
   at the same shapes, or HG2's one ``index_add_`` per feature on
   precomputed taps: a yardstick the port never calls) and, given ``--parent
   DIR`` (another checkout, e.g. the parent commit from ``git archive``),
   ``parent_ms`` / ``parent_ms_ray`` and ``parent_device_ms`` /
   ``parent_device_ms_ray`` (the tiled forwards also ``parent_ms_eval``, the forwards, K6,
   K8, HG2, HG4 and VM2 ``parent_ms_step``, VM1 / VM2 also
   ``parent_device_ms_step``: the same training step's operands, saved by this run
   under ``exp/chip_smoke/step_operands.pt``): that design's times from
   ``tools/bwd_bench.py --root DIR`` in this run;
24. the last line ``{"ok": true, "device": {...}}``.

Phase 3 also holds K13/K14 (the stacked fused density forward and backward:
C=64, nested R=(129, 2049) on one 2049-row table of 128 stacked components,
F=16, MLP 32->64->16) and phase 4 K11/K12 (the stacked product with its
Jacobian and the block-diagonal basis) and K5/K6 at R=129 and 2049 against
their plain versions, with the same limits.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
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
NEUS_RAW_CONFIG = os.path.join(CONFIGS, "neus-cp-raw-synthetic.yaml")
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
    kernel_out, plain_out = kernel_out.detach(), plain_out.detach()
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


# The redesigned kernels (the backwards of csrc/mma_common.cuh, the forwards
# K1 / K13 / cp_big's K1 and HG1): per kernel entry, its source stem, the
# mangled-name marker of its instantiation in ptxas' output (a forward's
# training mode; its eval mode in EVAL_MARKERS), and the key of its launch
# plan (ops/cuda_build.py PLANS, without the device)
REDESIGNED_KERNELS = {
    "cp_mlp_backward": ("cp_mlp_bwd", "cp_mlp_bwd_kernelILi64ELi16ELi2ELi64ELi1ELi16ELb0E",
                        ("cp_mlp_bwd", 64, 16, 2, 64, 1, 16)),
    "cp_mlp_stacked_backward": ("cp_mlp_bwd",
                                "cp_mlp_bwd_kernelILi64ELi16ELi2ELi64ELi1ELi16ELb1E",
                                ("cp_mlp_stacked_bwd", 64, 16, 2, 64, 1, 16)),
    "cp_mlp_backward@cp_big": ("cp_mlp_bwd",
                               "cp_mlp_bwd_kernelILi128ELi16ELi3ELi64ELi1ELi16ELb0E",
                               ("cp_mlp_bwd", 128, 16, 3, 64, 1, 16)),
    "sh_mlp_backward": ("sh_mlp_bwd", "sh_mlp_bwd_kernelILi16ELi4ELi64ELi2ELi3E",
                        ("sh_mlp_bwd", 16, 4, 64, 2, 3)),
    "cp_jac_basis_backward": ("cp_jac_basis_bwd", "cp_jac_basis_bwd_kernelILi64ELi16ELi1E",
                              ("cp_jac_basis_bwd", 64, 16)),
    "cp_jac_stacked_backward": ("cp_jac_basis_bwd", "cp_jac_basis_bwd_kernelILi64ELi16ELi2E",
                                ("cp_jac_stacked_bwd", 64, 16, 2)),
    "cp_jac_basis_backward@cp_big": ("cp_jac_basis_bwd",
                                     "cp_jac_basis_bwd_kernelILi128ELi16ELi1E",
                                     ("cp_jac_basis_bwd", 128, 16)),
    # grid-stride kernels of 128-thread blocks (HG2's static shared memory from
    # ptxas): no plan
    "hashgrid_backward": ("hashgrid_bwd", "hashgrid_bwd_kernelILi2E", None),
    "cp_mlp_forward": ("cp_mlp_fwd", "cp_mlp_fwd_kernelILi64ELi16ELi2ELi64ELi1ELi16ELb0ELb1E",
                       ("cp_mlp_fwd", 64, 16, 2, 64, 1, 16, True)),
    "cp_mlp_stacked_forward": ("cp_mlp_fwd",
                               "cp_mlp_fwd_kernelILi64ELi16ELi2ELi64ELi1ELi16ELb1ELb1E",
                               ("cp_mlp_stacked_fwd", 64, 16, 2, 64, 1, 16, True)),
    "cp_mlp_forward@cp_big": ("cp_mlp_fwd",
                              "cp_mlp_fwd_kernelILi128ELi16ELi3ELi64ELi1ELi16ELb0ELb1E",
                              ("cp_mlp_fwd", 128, 16, 3, 64, 1, 16, True)),
    "hashgrid_forward": ("hashgrid_fwd", "hashgrid_fwd_kernelILi2ELi4E", None),
    "cp_product_jac_backward": ("cp_jac_basis_bwd", "cp_jac_basis_bwd_kernelILi64ELi0ELi1ELb0E",
                                ("cp_product_jac_bwd", 64)),
    "cp_product_jac_backward@cp_big": ("cp_jac_basis_bwd",
                                       "cp_jac_basis_bwd_kernelILi128ELi0ELi1ELb0E",
                                       ("cp_product_jac_bwd", 128)),
    "cp_product_backward": ("cp_jac_basis_bwd", "cp_jac_basis_bwd_kernelILi64ELi0ELi1ELb1E",
                            ("cp_product_bwd", 64)),
    "cp_product_backward@cp_big": ("cp_jac_basis_bwd",
                                   "cp_jac_basis_bwd_kernelILi128ELi0ELi1ELb1E",
                                   ("cp_product_bwd", 128)),
    "sh_mlp_forward": ("sh_mlp_fwd", "sh_mlp_fwd_kernelILi16ELi4ELi64ELi2ELi3ELb1E",
                       ("sh_mlp_fwd", 16, 4, 64, 2, 3, True)),
    "cp_product_forward": ("cp_product_fwd", "cp_product_fwd_kernelILi64ELb1E",
                           ("cp_product_fwd", 64, True)),
    "cp_product_forward@cp_big": ("cp_product_fwd", "cp_product_fwd_kernelILi128ELb1E",
                                  ("cp_product_fwd", 128, True)),
    "cp_jac_basis_forward": ("cp_jac_basis_fwd", "cp_jac_basis_fwd_kernelILi64ELi16ELi1ELb1E",
                             ("cp_jac_basis_fwd", 64, 16, True)),
    "cp_jac_basis_forward@cp_big": ("cp_jac_basis_fwd",
                                    "cp_jac_basis_fwd_kernelILi128ELi16ELi1ELb1E",
                                    ("cp_jac_basis_fwd", 128, 16, True)),
    "cp_jac_stacked_forward": ("cp_jac_basis_fwd", "cp_jac_basis_fwd_kernelILi64ELi16ELi2ELb1E",
                               ("cp_jac_stacked_fwd", 64, 16, 2, True)),
    # HG3 (a grid of 128-thread blocks, 4 levels a thread at 12 levels) and HG4
    # (one wave of 128-thread blocks): no plan
    "hashgrid_jac_forward": ("hashgrid_jac_fwd", "hashgrid_jac_fwd_kernelILi2ELi4E", None),
    "hashgrid_jac_backward": ("hashgrid_jac_bwd", "hashgrid_jac_bwd_kernelILi2E", None),
    # VM1 / VM2 at the VM NeRF's 16 components (128-thread blocks): no plan
    "vm_forward": ("vm_fwd", "vm_fwd_kernelILi16E", None),
    "vm_backward": ("vm_bwd", "vm_bwd_kernelILi16ELb0E", None),
}
EVAL_MARKERS = {name: (stem, marker[:-len("ELb1E")] + "ELb0E", (*plan[:-1], False))
                for name, (stem, marker, plan) in REDESIGNED_KERNELS.items()
                if stem in ("cp_mlp_fwd", "sh_mlp_fwd", "cp_product_fwd", "cp_jac_basis_fwd")}
# a training step's own operands of the redesigned kernels (captured in the
# last step of a training run), the kernels' times on them, and the
# forwards' operands as tools/bwd_bench.py --step-operands reads them
STEP_MS = {}
STEP_DEVICE_MS = {}  # VM1 / VM2: device ms on the step's own operands
STEP_OPERANDS = {}
# the packed K3 / K4 weights of a captured step with the parameters they
# were packed from: (ws, mlp params, n_pre)
SH_PACKS = []
STEP_OPERANDS_PATH = os.path.join(ROOT, "exp", "chip_smoke", "step_operands.pt")


def ptxas_info(stem, marker):
    """Registers, stack frame and spill bytes of the kernel whose mangled
    name holds ``marker``, from ``nvcc -Xptxas -v``'s output of the build of
    ``csrc/<stem>.cu``'s library that this run loads (``cuda_build.build_log``:
    this process's build, or the log an earlier build left beside the
    library; None when there is neither)."""
    import re

    from instant_nsr_pl_tpu_torch.ops import cuda_build

    log = cuda_build.build_log(stem)
    if not log:
        return None
    info, inside = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = marker in line
        elif inside:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    info[key] = int(m.group(1))
    return info or None


def _step_entry(name, calls):
    """A step's launch arguments as ``tools/bwd_bench.py --step-operands``
    reads them (plain tensors and numbers, so another checkout can load
    them): the last launch of a fused forward and of HG1-HG4, every launch of K8
    (one per scale) and of K6 (without its residual, which K5 makes again),
    and every training-mode launch of K5 (a finite-difference step's four, on
    the tensors K6's entry holds: one ``torch.save`` keeps them once), K9
    (one per scale) and K11."""
    kinds = {"cp_product_forward": "prod_fwd", "cp_jac_basis_forward": "jacb",
             "cp_jac_stacked_forward": "jacs"}
    if name in kinds:
        return {"kind": kinds[name], "launches": [[t.detach() if torch.is_tensor(t) else t
                                                   for t in a] for a, _ in calls]}
    if name == "cp_product_backward":
        return {"kind": "prod", "launches": [[lines.detach(), u3.detach(), dprod.detach(), res]
                                             for (lines, u3, _, dprod, res), _ in calls]}
    if name == "cp_product_jac_backward":
        return {"kind": "raw", "launches": [[t.detach() if torch.is_tensor(t) else t for t in a]
                                            for a, _ in calls]}
    args, kwargs = calls[-1]
    if name in ("vm_forward", "vm_backward"):
        # (params, x, spec) or (params, x, dout, spec[, with_dx])
        params, x, *rest = args
        entry = {"kind": "vm_fwd" if name == "vm_forward" else "vm_bwd",
                 "params": {k: t.detach() for k, t in params.items()}, "x": x.detach(),
                 "spec": dataclasses.asdict(rest[-1] if name == "vm_forward" else rest[1])}
        if name == "vm_backward":
            entry["dout"] = rest[0].detach()
            entry["with_dx"] = bool(rest[2] if len(rest) > 2 else kwargs.get("with_dx", False))
        return entry
    if name == "sh_mlp_forward":
        ops, feats, dirs, spec, degree = args[:5]
        return {"kind": "sh", "ops": list(ops), "feats": feats.detach(), "dirs": dirs.detach(),
                "degree": degree, "train": bool(kwargs.get("train", False)),
                "mlp": (spec.dim_in, spec.dim_out, spec.n_neurons, spec.n_hidden_layers)}
    if name in ("hashgrid_forward", "hashgrid_jac_forward", "hashgrid_backward",
                "hashgrid_jac_backward"):
        # (table, x, [cotangents,] spec, level_mask[, with_dx]): HG1 / HG3,
        # HG2 (one cotangent) and HG4 (two)
        n_ct = {"hashgrid_backward": 1, "hashgrid_jac_backward": 2}.get(name, 0)
        table, x, *cts = args[:2 + n_ct]
        spec = args[2 + n_ct]
        rest = args[3 + n_ct:]
        entry = {"kind": {"hashgrid_forward": "hash", "hashgrid_jac_forward": "hash_jac",
                          "hashgrid_backward": "hash_bwd",
                          "hashgrid_jac_backward": "hash_jac_bwd"}[name],
                 "table": table.detach(), "x": x.detach(),
                 "mask": rest[0] if rest else kwargs.get("level_mask"),
                 "spec": {k: getattr(spec, k) for k in (
                     "n_levels", "n_features_per_level", "log2_hashmap_size", "base_resolution",
                     "per_level_scale", "n_input_dims")}}
        if n_ct:
            entry["with_dx"] = bool(rest[1] if len(rest) > 1 else kwargs.get("with_dx", False))
            entry.update(zip(("dout",) if n_ct == 1 else ("ct_feat", "ct_jac"),
                             (t.detach() for t in cts)))
        return entry
    ops, x, cp_spec, mlp_spec = args[:4]
    ops = (list(ops[0]) if isinstance(ops[0], (list, tuple)) else ops[0], *ops[1:])
    return {"kind": "cp", "ops": ops, "x": x.detach(), "stacked": name.startswith("cp_mlp_st"),
            "train": bool(kwargs.get("train", args[4] if len(args) > 4 else False)),
            "cp": (cp_spec.n_components, tuple(cp_spec.resolutions), cp_spec.n_features),
            "mlp": (mlp_spec.dim_in, mlp_spec.dim_out, mlp_spec.n_neurons,
                    mlp_spec.n_hidden_layers)}


# chip_smoke entry name -> tools/bwd_bench.py case
BENCH_KEY = {"cp_mlp_backward": "k2", "cp_mlp_stacked_backward": "k14",
             "cp_mlp_backward@cp_big": "k2_cp_big", "sh_mlp_backward": "k4",
             "cp_jac_basis_backward": "k10", "cp_jac_stacked_backward": "k12",
             "cp_jac_basis_backward@cp_big": "k10_cp_big", "hashgrid_backward": "hg2",
             "cp_mlp_forward": "k1", "cp_mlp_stacked_forward": "k13",
             "cp_mlp_forward@cp_big": "k1_cp_big", "hashgrid_forward": "hg1",
             "cp_product_jac_backward": "k8", "cp_product_jac_backward@cp_big": "k8_cp_big",
             "cp_product_backward": "k6", "cp_product_backward@cp_big": "k6_cp_big",
             "sh_mlp_forward": "k3", "cp_product_forward": "k5",
             "cp_product_forward@cp_big": "k5_cp_big", "cp_jac_basis_forward": "k9",
             "cp_jac_basis_forward@cp_big": "k9_cp_big", "cp_jac_stacked_forward": "k11",
             "hashgrid_jac_forward": "hg3", "hashgrid_jac_backward": "hg4",
             "vm_forward": "vm1", "vm_backward": "vm2"}
# the backwards whose every launch of a step is kept for the parent design's timing
STEP_BACKWARDS = ("cp_product_jac_backward", "cp_product_backward", "hashgrid_backward",
                  "hashgrid_jac_backward", "vm_backward")
# the launches a capture records in training mode only (a grid update's or a
# rendered view's eval launches are not the step's forward)
TRAIN_ONLY = ("cp_mlp_forward", "cp_mlp_stacked_forward", "sh_mlp_forward", "cp_product_forward",
              "cp_jac_basis_forward", "cp_jac_stacked_forward")


def capture_step_operands(run_step, label, check=None):
    """Run ``run_step()`` (one training step) with the launch functions of
    the redesigned kernels recording their arguments: the backwards K2, K14,
    K4, K6, K8, K10, K12 and HG2, the training-mode forwards K1, K13, K3, K5,
    K9, K11 and HG1, and HG3 / HG4 (a NeuS hash step's); then time each
    recorded kernel on its step's own (ray-ordered) operands, all of its launches of the step in a row (K8, K9,
    K10: one per scale; K5, K6: one per scale at N and at 6N), into
    ``STEP_MS[name]`` as
    ``(ms, n of the last launch, n of each launch)``, and keep the forwards',
    K6's, K8's and HG2's arguments in ``STEP_OPERANDS`` for the parent design's
    timing (HG2's too). ``check(name, calls)``, if given, sees each kernel's recorded
    calls (``(args, kwargs)`` each) before they are timed. The recorders call
    the launch functions themselves, so the step's launch counts are
    unchanged, and the counts are restored after the check and the timing
    launches."""
    from instant_nsr_pl_tpu_torch.ops import cp_mlp, cp_product, cp_stacked, hashgrid, sh_mlp, vm

    seen = {}
    originals = {}
    # name: (module, launch function, counter, the samples of a call's arguments)
    targets = {
        "cp_mlp_backward": (cp_mlp, "cp_mlp_backward_launch", cp_mlp.cp_mlp_backward,
                            lambda a: a[0].reshape(-1, 3).shape[0]),
        "cp_mlp_stacked_backward": (cp_mlp, "cp_mlp_stacked_backward_launch",
                                    cp_mlp.cp_mlp_stacked_backward,
                                    lambda a: a[0].reshape(-1, 3).shape[0]),
        "sh_mlp_backward": (sh_mlp, "sh_mlp_backward_launch", sh_mlp.sh_mlp_backward,
                            lambda a: a[0].shape[0]),
        "cp_jac_basis_backward": (cp_product, "cp_product_jac_basis_backward_launch",
                                  cp_product.cp_product_jac_basis_backward,
                                  lambda a: a[0].shape[1]),
        "cp_jac_stacked_backward": (cp_stacked, "cp_jac_basis_stacked_backward_launch",
                                    cp_stacked.cp_jac_basis_stacked_backward,
                                    lambda a: a[0].shape[1]),
        "hashgrid_backward": (hashgrid, "hashgrid_backward_launch", hashgrid.hashgrid_backward,
                              lambda a: a[1].reshape(-1, 3).shape[0]),
        "cp_mlp_forward": (cp_mlp, "cp_mlp_launch", cp_mlp.cp_mlp_forward,
                           lambda a: a[1].reshape(-1, 3).shape[0]),
        "cp_mlp_stacked_forward": (cp_mlp, "cp_mlp_stacked_launch", cp_mlp.cp_mlp_stacked_forward,
                                   lambda a: a[1].reshape(-1, 3).shape[0]),
        "hashgrid_forward": (hashgrid, "hashgrid_forward_launch", hashgrid.hashgrid_forward,
                             lambda a: a[1].reshape(-1, 3).shape[0]),
        "cp_product_jac_backward": (cp_product, "cp_product_jac_backward_launch",
                                    cp_product.cp_product_jac_backward, lambda a: a[0].shape[1]),
        "cp_product_backward": (cp_product, "cp_product_backward_launch",
                                cp_product.cp_product_backward, lambda a: a[1].shape[1]),
        "sh_mlp_forward": (sh_mlp, "sh_mlp_launch", sh_mlp.sh_mlp_forward,
                           lambda a: a[1].reshape(-1, a[1].shape[-1]).shape[0]),
        "cp_product_forward": (cp_product, "cp_product_launch", cp_product.cp_product,
                               lambda a: a[1].shape[1]),
        "cp_jac_basis_forward": (cp_product, "cp_product_jac_basis_launch",
                                 cp_product.cp_product_jac_basis, lambda a: a[2].shape[1]),
        "cp_jac_stacked_forward": (cp_stacked, "cp_jac_basis_stacked_launch",
                                   cp_stacked.cp_jac_basis_stacked, lambda a: a[2].shape[1]),
        "hashgrid_jac_forward": (hashgrid, "hashgrid_jac_forward_launch",
                                 hashgrid.hashgrid_jac_forward,
                                 lambda a: a[1].reshape(-1, 3).shape[0]),
        "hashgrid_jac_backward": (hashgrid, "hashgrid_jac_backward_launch",
                                  hashgrid.hashgrid_jac_backward,
                                  lambda a: a[1].reshape(-1, 3).shape[0]),
        "vm_forward": (vm, "vm_forward_launch", vm.vm_forward,
                       lambda a: a[1].reshape(-1, 3).shape[0]),
        "vm_backward": (vm, "vm_backward_launch", vm.vm_backward,
                        lambda a: a[1].reshape(-1, 3).shape[0]),
    }
    pack_fn = sh_mlp.pack_sh_mlp

    def record_pack(mlp_params, mlp_spec, degree, n_pre, n_feat):
        out = pack_fn(mlp_params, mlp_spec, degree, n_pre, n_feat)
        # copies: the step's optimizer update changes the parameters in place
        SH_PACKS.append((out[0], [{k: t.detach().clone() for k, t in layer.items()}
                                  for layer in mlp_params], n_pre))
        return out

    sh_mlp.pack_sh_mlp = record_pack
    for name, (mod, attr, _, _) in targets.items():
        fn = getattr(mod, attr)
        originals[name] = fn

        def record(*args, _name=name, _fn=fn, **kwargs):
            if _name not in TRAIN_ONLY or kwargs.get("train", False):
                seen.setdefault(_name, []).append((args, kwargs))
            return _fn(*args, **kwargs)

        setattr(mod, attr, record)
    try:
        out = run_step()
    finally:
        sh_mlp.pack_sh_mlp = pack_fn
        for name, (mod, attr, _, _) in targets.items():
            setattr(mod, attr, originals[name])
    torch.cuda.synchronize()
    for name, calls in seen.items():
        key = f"{name}{label}"
        if key in STEP_MS:
            continue
        counter, n_of = targets[name][2], targets[name][3]
        count = counter.launches  # check and timing launches are not the run's
        if check is not None:
            check(key, calls)
        ms = time_ms(lambda: [originals[name](*a, **kw) for a, kw in calls])
        if name in ("vm_forward", "vm_backward"):
            STEP_DEVICE_MS[key] = device_ms(lambda: [originals[name](*a, **kw) for a, kw in calls])
        counter.launches = count
        STEP_MS[key] = (ms, int(n_of(calls[-1][0])), [int(n_of(a)) for a, _ in calls])
        if key in BENCH_KEY and (name.endswith("forward") or name in STEP_BACKWARDS):
            STEP_OPERANDS[BENCH_KEY[key]] = _step_entry(name, calls)
        print(f"[step-operands] {key}: {ms:.4f} ms on a training step's own operands "
              f"({len(calls)} launch(es), N={STEP_MS[key][1]})", flush=True)
    SH_PACKS.clear()
    return out


def composed_backward(kind, device, n=N_FULL, c=64, s_count=2):
    """A yardstick, never called by the port: the products of K2 (``kind``
    "cp", the bench head; C=128, S=3 for cp_big) or K4 ("sh", the bench
    radiance head) as a chain of torch.matmul calls on bf16 operands at the
    kernels' shapes, without their elementwise work and the line-table
    scatter. Returns its CUDA-event time in ms."""
    gen = torch.Generator().manual_seed(SEED + 3)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(device, torch.bfloat16)

    if kind == "sh":
        x0, h0, h1, dout = r(n, 32), r(n, 64), r(n, 64), r(n, 3)
        w0, w1, w2 = r(32, 64), r(64, 64), r(64, 3)
        g1, g0 = r(n, 64), r(n, 64)

        def chain():
            torch.matmul(h1.T, dout)
            torch.matmul(dout, w2.T)
            torch.matmul(h0.T, g1)
            torch.matmul(g1, w1.T)
            torch.matmul(x0.T, g0)
            torch.matmul(g0, w0.T)
    else:
        f, e = 16, 16 * s_count
        prods = [r(n, c) for _ in range(s_count)]
        bases = [r(c, f) for _ in range(s_count)]
        h, dout, g0, enc, denc = r(n, 64), r(n, 16), r(n, 64), r(n, e), r(n, e)
        w0, w1 = r(e, 64), r(64, 16)

        def chain():
            for p, b in zip(prods, bases):
                torch.matmul(p, b)
            torch.matmul(h.T, dout)
            torch.matmul(dout, w1.T)
            torch.matmul(enc.T, g0)
            torch.matmul(g0, w0.T)
            for k, (p, b) in enumerate(zip(prods, bases)):
                torch.matmul(p.T, denc[:, k * f:(k + 1) * f])
                torch.matmul(denc[:, k * f:(k + 1) * f], b.T)
    return time_ms(chain)


def composed_jac(device, c=64, f=16, scales=2, n=N_FULL):
    """A yardstick, never called by the port: K10's five products per scale
    (``scales`` launches, or K12's scales) as torch.matmul calls on bf16
    operands at the kernel's shapes: [dP | dJ_x | dJ_y | dJ_z] = B [d enc |
    d jac] as four (C, F) x (F, N) products and d B as one (C, 4N) x (4N, F)
    product, without the elementwise work and the line-table scatter."""
    gen = torch.Generator().manual_seed(SEED + 5)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(device, torch.bfloat16)

    per = [(r(c, f), r(f, 4 * n), r(c, 4 * n)) for _ in range(scales)]

    def chain():
        for b, cot, a in per:
            for k in range(4):
                torch.matmul(b, cot[:, k * n:(k + 1) * n])
            torch.matmul(a, cot.T)
    return time_ms(chain)


def composed_hash(device, spec, x, ct):
    """A yardstick, never called by the port: HG2's table gradient from
    precomputed taps (the 8 corners' rows and weights of every level, as the
    JAX package saves them) with one ``index_add_`` per feature."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    xt = x.T.contiguous()
    f = spec.n_features_per_level
    idx, upd = [], []
    for lv in range(spec.n_levels):
        i, w = hg.level_corner_indices(spec, xt, lv)  # (8, N)
        idx.append(i.reshape(-1))
        upd.append((w[None] * ct[:, lv * f:(lv + 1) * f].T[:, None, :]).reshape(f, -1))
    return _index_add_ms(device, spec, torch.cat(idx), torch.cat(upd, dim=1))


def composed_hash_jac(device, spec, x, ct_f, ct_j):
    """A yardstick, never called by the port: HG4's table gradient from
    precomputed taps and updates (``w_c ct_f + sum_d dw_cd ct_j[d]`` of every
    level's 8 corners, as the JAX package forms them from its saved taps)
    with one ``index_add_`` per feature."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    xt = x.T.contiguous()
    f = spec.n_features_per_level
    idx, upd = [], []
    for lv in range(spec.n_levels):
        i, w, frac = hg._level_taps(spec, xt, lv)  # (8, N)
        dw, _ = hg._corner_partials(frac, hg._scale32(spec, lv))  # (8, 3, N)
        g_f = ct_f[:, lv * f:(lv + 1) * f].T  # (F, N)
        g_j = ct_j[:, :, lv * f:(lv + 1) * f].transpose(1, 2)  # (3, F, N)
        u = w[None] * g_f[:, None, :] + (dw.transpose(0, 1)[:, None] * g_j[:, :, None, :]).sum(0)
        idx.append(i.reshape(-1))
        upd.append(u.reshape(f, -1))
    return _index_add_ms(device, spec, torch.cat(idx), torch.cat(upd, dim=1))


def _index_add_ms(device, spec, idx, upd):
    """CUDA-event time of the (F, T) table gradient from rows ``idx`` and
    updates ``upd`` (F, M): the zeroed gradient and one ``index_add_`` per
    feature."""
    f = spec.n_features_per_level
    out = torch.zeros((f, spec.total_params), dtype=torch.float32, device=device)

    def scatter():
        out.zero_()
        for k in range(f):
            out[k].index_add_(0, idx, upd[k])
    return time_ms(scatter)


def device_ms(fn):
    """Device time per call under torch.profiler (every kernel and memset of
    a call; ``tools/bwd_bench.py``): unlike ``time_ms`` it leaves out the
    host's share where the host queues calls slower than the card runs
    them."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import device_ms as profiled

    return profiled(fn)[0]


def parent_times(parent):
    """The parent design's times of the redesigned kernels at N_FULL on
    uniform and ray-ordered operands, back to back and as device time, and
    of the forwards on the training steps' own operands saved by this run
    (``STEP_OPERANDS_PATH``): ``tools/bwd_bench.py --root parent`` in a
    process of its own (it imports the other checkout's port)."""
    out = os.path.join(ROOT, "exp", "chip_smoke", "parent_bwd.json")
    cmd = [sys.executable, os.path.join(ROOT, "instant_nsr_pl_tpu_torch", "tools", "bwd_bench.py"),
           "--root", parent, "--order", "uniform,ray", "--step-operands", STEP_OPERANDS_PATH,
           "--out", out]
    subprocess.run(cmd, check=True, timeout=900)
    with open(out) as fh:
        result = json.load(fh)
    return result["ms"], result["device_ms"]


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

    # the kernels alone, on operands packed here (the eval ops pack once per weights version)
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
        if not torch.equal(got, launch(False)[0]):
            raise AssertionError(f"{name}: eval and training mode disagree")
        for label, a, b in zip(("vsave", "hsave") if key == "cp" else ("hsave",), res, ref_res):
            frac = float((a != b).float().mean())
            print(f"[kernel] {name} training mode: {label} {tuple(a.shape)} differs from the "
                  f"plain version's in {frac:.2e} of its entries", flush=True)
            if frac > 1e-3:
                raise AssertionError(f"{name}: residual {label} disagrees with its plain version")
            compare(f"{name} training mode {label}", a.float(), b.float())
        ms = time_ms(lambda: launch(False))
        ms_train = time_ms(lambda: launch(True))
        dev_ms, dev_ms_train = device_ms(lambda: launch(False)), device_ms(lambda: launch(True))
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
        print(f"[kernel] {name}: {ms:.4f} ms eval, {ms_train:.4f} ms training mode (device "
              f"{dev_ms:.4f} / {dev_ms_train:.4f}; through the op {op_ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by}, {bound_train_ms:.4f} "
              f"ms with residuals) at N={N_FULL}", flush=True)
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"instant_nsr_pl_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": 0, "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms,
            "ms_train": ms_train, "device_ms": dev_ms, "device_ms_train": dev_ms_train,
            "op_ms": op_ms, "plain_ms": plain_ms,
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
        dev_ms = device_ms(lambda: launch(*args))
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
        composed_ms = composed_backward("cp" if name == "cp_mlp_backward" else "sh", device)
        print(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
              f"by {bound_by}; its products as torch.matmul calls {composed_ms:.4f} ms) at "
              f"N={N_FULL}", flush=True)
        entries[name] = {
            "composed_ms": composed_ms, "device_ms": dev_ms,
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


def cp_kernel_phase(device, c=64, f=16, resolutions=(128, 2048),
                    stacked_resolutions=(129, 2049), suffix=""):
    """K5/K6 (the CP product), K7/K8 (the product with its Jacobian) and
    K9/K10 (the product with its Jacobian and the basis projection) at the
    bench NeuS encoding (C=64, F=16) for both scales (R=128 and 2048), and
    K5/K6 at the stacked encoding's per-scale resolutions (R=129 and 2049:
    its grid updates and finite differences), at N=262,144 and 262,107, each
    against its plain version on the same inputs, then timed. The
    training-mode residuals must equal the plain ones to the bit; forwards
    lie within 2e-2 * max|plain|, gradients within 2.5e-2 * max|plain|.
    Another encoding (``bench.py --encoding cp_big``: C=128, R=(64, 512,
    4096)) is held the same way with its own arguments, its entries named
    with ``suffix``."""
    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp

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
    djac_raw = torch.randn((3, c, N_FULL), generator=gen).to(device)
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
    for name in ("cp_product_forward", "cp_product_backward", "cp_product_jac_forward",
                 "cp_product_jac_backward", "cp_jac_basis_forward", "cp_jac_basis_backward"):
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
            if not torch.equal(prod, ref):  # no sum: prod is the plain one to the bit
                raise AssertionError(f"cp_product_forward {tag}: prod differs from the plain "
                                     f"version's in {float((prod != ref).float().mean()):.2e} "
                                     "of its entries")
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
            # K7: eval and training mode
            prod_e, jac_e, v_e, g_e = cpp.cp_product_jac_launch(lines, u, r)
            prod_k7, jac_k7, vsave_k7, gdsave_k7 = cpp.cp_product_jac_launch(lines, u, r,
                                                                            train=True)
            torch.cuda.synchronize()
            assert v_e is None and g_e is None, "K7 eval mode wrote residuals"
            assert torch.equal(prod_k7, prod_e) and torch.equal(jac_k7, jac_e)
            ref_k7 = cpp.cp_product_jac_plain(lines, u, r, save_residuals=True)
            residuals_equal(f"cp_product_jac_forward {tag}", (vsave_k7, gdsave_k7), ref_k7[2:])
            for label, a, b in zip(("prod", "jac"), (prod_k7, jac_k7), ref_k7[:2]):
                out["cp_product_jac_forward"]["errs"].append(
                    compare(f"cp_product_jac_forward {tag} {label}", a, b))
            # K8 from those residuals
            djr = djac_raw[:, :, :n].contiguous()
            got = cpp.cp_product_jac_backward_launch(u, vsave_k7, gdsave_k7, dp, djr, r)
            torch.cuda.synchronize()
            ref_b = cpp.cp_product_jac_backward_plain(u, vsave_k7, gdsave_k7, dp, djr, r)
            for label, a, b in zip(("d lines", "d u"), got, ref_b):
                out["cp_product_jac_backward"]["errs"].append(
                    compare(f"cp_product_jac_backward {tag} {label}", a, b, rel=2.5e-2))
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
            again = cpp.cp_product_jac_basis_backward_launch(u, vsave_j, gdsave, de, dj, basis, r)
            torch.cuda.synchronize()
            if not torch.equal(got[2], again[2]):
                raise AssertionError(f"cp_jac_basis_backward {tag}: d basis differs between two "
                                     "identical calls")
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
            "cp_product_jac_forward": (
                lambda: cpp.cp_product_jac_launch(lines, u, r, train=True),
                lambda: cpp.cp_product_jac_plain(lines, u, r, save_residuals=True),
                n * (12 + 16 * c + 12 * c) + 2 * tb, n * c * 23),
            "cp_product_jac_backward": (
                lambda: cpp.cp_product_jac_backward_launch(u, vsave_k7, gdsave_k7, dp, djr, r),
                lambda: cpp.cp_product_jac_backward_plain(u, vsave_k7, gdsave_k7, dp, djr, r),
                n * (12 + 12 * c + 4 * c + 12 * c + 12) + 4 * tb, n * c * 40),
            "cp_jac_basis_forward": (
                lambda: cpp.cp_product_jac_basis_launch(lines, basis, u, r, train=True),
                lambda: cpp.cp_product_jac_basis_plain(lines, basis, u, r, save_residuals=True),
                n * (12 + 16 * f + 12 * c) + 2 * tb + 2 * c * f, n * c * 23),
            "cp_jac_basis_backward": (
                lambda: cpp.cp_product_jac_basis_backward_launch(u, vsave_j, gdsave, de, dj,
                                                                 basis, r),
                lambda: cpp.cp_product_jac_basis_backward_plain(u, vsave_j, gdsave, de, dj,
                                                                basis, r),
                n * (12 + 12 * c + 16 * f + 12) + 4 * tb + 2 * c * f + 4 * c * f,
                n * c * 40),
        }
        # K9's projections (B^T [P | J]) and K10's products (B [d enc | d jac] and
        # d B) are bf16 x bf16 on the tensor cores
        bf16_ops = {"cp_jac_basis_forward": n * 8 * c * f, "cp_jac_basis_backward": n * 16 * c * f}
        for name, (kern, plain, n_bytes, f32_ops) in timed.items():
            if not with_jac and name.startswith(("cp_jac", "cp_product_jac")):
                continue
            e = out[name]
            e["ms"][r] = time_ms(kern)
            e["plain_ms"][r] = time_ms(plain, reps=5, inner=2)
            e["bound_ms"][r], e["bound_by"][r] = bound(n_bytes, bf16_ops.get(name, 0), f32_ops)
            if name in bf16_ops or name == "cp_product_backward":
                e.setdefault("device_ms", {})[r] = device_ms(kern)
            print(f"[kernel] {name} R={r}: {e['ms'][r]:.4f} ms (plain {e['plain_ms'][r]:.3f} "
                  f"ms; bound {e['bound_ms'][r]:.4f} ms by {e['bound_by'][r]}) at N={n}",
                  flush=True)
        # the forwards in eval mode: K5 (grid updates, the level grid), K7
        # (export vertex colours, rendered views) and K9 (rendered views)
        evals = {"cp_product_forward": (lambda: cpp.cp_product_launch(lines, u, r),
                                        n * (12 + 4 * c) + 2 * tb, 0, n * c * 11)}
        if with_jac:
            evals["cp_product_jac_forward"] = (lambda: cpp.cp_product_jac_launch(lines, u, r),
                                               n * (12 + 16 * c) + 2 * tb, 0, n * c * 23)
            evals["cp_jac_basis_forward"] = (
                lambda: cpp.cp_product_jac_basis_launch(lines, basis, u, r),
                n * (12 + 16 * f) + 2 * tb + 2 * c * f, n * 8 * c * f, n * c * 23)
        for name, (kern, n_bytes, bf16_n, f32_n) in evals.items():
            e = out[name]
            e.setdefault("ms_eval", {})[r] = time_ms(kern)
            e.setdefault("bound_ms_eval", {})[r] = bound(n_bytes, bf16_n, f32_n)[0]
            print(f"[kernel] {name} R={r}: {e['ms_eval'][r]:.4f} ms eval (bound "
                  f"{e['bound_ms_eval'][r]:.4f} ms) at N={n}", flush=True)

    meta = {
        "cp_product_forward": ("cp_product_fwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:242"),
        "cp_product_backward": ("cp_jac_basis_bwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:277"),
        "cp_product_jac_forward": ("cp_product_jac_fwd.cu",
                                   "instant_nsr_pl_tpu/ops/cp_pallas.py:424"),
        "cp_product_jac_backward": ("cp_jac_basis_bwd.cu",
                                    "instant_nsr_pl_tpu/ops/cp_pallas.py:464"),
        "cp_jac_basis_forward": ("cp_jac_basis_fwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:633"),
        "cp_jac_basis_backward": ("cp_jac_basis_bwd.cu", "instant_nsr_pl_tpu/ops/cp_pallas.py:676"),
    }
    entries = []
    for name, (src, replaces) in meta.items():
        e = out[name]
        by = e["bound_by"][resolutions[-1]]
        entry = {
            "name": name + suffix, "route": "cuda",
            "source": f"instant_nsr_pl_tpu_torch/csrc/{src}",
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
        if suffix:
            entry["shape"] = f"C={c}, R={resolutions}, F={f}"
        if name in ("cp_product_forward", "cp_product_backward") and stacked_resolutions:
            entry["ms_stacked_scales"] = sum(e["ms"][r] for r in stacked_resolutions)
            entry["bound_ms_stacked_scales"] = sum(e["bound_ms"][r] for r in stacked_resolutions)
        if "ms_eval" in e:
            entry["ms_eval"] = sum(e["ms_eval"][r] for r in resolutions)
            entry["bound_ms_eval"] = sum(e["bound_ms_eval"][r] for r in resolutions)
        if "device_ms" in e:
            entry["device_ms"] = sum(e["device_ms"][r] for r in resolutions)
        if name == "cp_jac_basis_backward":
            entry["composed_ms"] = composed_jac(device, c, f, len(resolutions))
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
        again = cps.cp_jac_basis_stacked_backward_launch(*jac_bwd_args)
        torch.cuda.synchronize()
        if not torch.equal(got[2], again[2]):
            raise AssertionError(f"cp_jac_stacked_backward {tag}: d basis differs between two "
                                 "identical calls")
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
            n * (12 + 16 * e + 12 * sc) + table * 2 + sc * f * 2, n * 8 * sc * f, n * sc * 23),
        "cp_jac_stacked_backward": (
            lambda: cps.cp_jac_basis_stacked_backward_launch(*jac_bwd_args),
            lambda: cps.cp_jac_basis_stacked_backward_plain(*jac_bwd_args),
            n * (12 + 12 * sc + 16 * e + 12) + table * 4 + sc * f * 2 + sc * f * 4,
            n * 16 * sc * f, n * sc * 40),
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
        if name == "cp_mlp_stacked_backward":
            entry["composed_ms"] = composed_backward("cp", device)
            entry["device_ms"] = device_ms(kern)
        elif name == "cp_jac_stacked_backward":
            entry["composed_ms"] = composed_jac(device, c, f, s_count)
            entry["device_ms"] = device_ms(kern)
        if name == "cp_mlp_stacked_forward":
            entry["ms_eval"] = time_ms(lambda: cp_mlp.cp_mlp_stacked_launch(ops, x, cp_spec, d_spec))
        elif name == "cp_jac_stacked_forward":
            entry["ms_eval"] = time_ms(lambda: cps.cp_jac_basis_stacked_launch(lines, basis, u3, rmax))
            entry["bound_ms_eval"] = bound(n * (12 + 16 * e) + table * 2 + sc * f * 2,
                                           n * 8 * sc * f, n * sc * 23)[0]
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


def step_profiler():
    """Start torch.profiler over the training steps that follow; the returned
    ``stop(steps)`` ends it and gives, per step, the device time of every
    kernel and memset (as ``scripts/profile_torch_train.py`` counts it), the
    wall, the device's busy share and the device launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()

    def stop(steps):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.stop()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        return {"device_ms_per_step": busy / steps, "profiled_ms_per_step": wall * 1e3 / steps,
                "busy_share": busy / (wall * 1e3), "device_launches_per_step": len(kernels) / steps}
    return stop


def train_phase(device, smi, config=BENCH_CONFIG, kind="cp"):
    """The bench NeRF (``kind`` "cp"), the stacked NeRF ("stacked": K13/K14
    for K1/K2), the hash NeRF ("hash": HG1/HG2 for K1/K2, the composed
    encoding -> bf16 MLP) or the VM NeRF ("vm": VM1/VM2 for K1/K2, composed
    likewise; the last step's VM1 / VM2 launches held against their plain
    versions, then its mesh, ``vm_mesh_phase``) trained through
    NeRFSystem.train_step for TRAIN_STEPS steps."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.models.network_utils import (
        HashGridEncoding,
        VectorMatrixEncoding,
        named_leaves,
    )
    from instant_nsr_pl_tpu_torch.ops import cp_mlp, hashgrid, sh_mlp, vm
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays

    tag = {"cp": "train", "stacked": "train-stacked", "hash": "train-hash", "vm": "train-vm"}[kind]
    cfg = config_from_dict(bench_config(config))
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("fit")
    system = systems.make(cfg.system.name, cfg)  # on CUDA by default
    system.setup_data(dm.train)
    val = dataset_device_arrays(dm.val, device)
    state = system.init_state(seed=SEED)
    model, params = system.model, state["params"]
    ewn = model.geometry.encoding_with_network
    if kind in ("hash", "vm"):
        inner = ewn.encoding.encoding
        assert not ewn.fused and isinstance(inner, VectorMatrixEncoding if kind == "vm"
                                            else HashGridEncoding) and inner.grad_mode == "fast"
    else:
        assert ewn.fused and ewn.encoding.encoding.stack_scales == (kind == "stacked")
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
    density = {"cp": "cp_mlp", "stacked": "cp_mlp_stacked", "hash": "hashgrid", "vm": "vm"}[kind]
    module = {"hash": hashgrid, "vm": vm}.get(kind, cp_mlp)
    counters = {f"{density}_forward": getattr(module, f"{density}_forward"),
                f"{density}_backward": getattr(module, f"{density}_backward"),
                "sh_mlp_forward": sh_mlp.sh_mlp_forward, "sh_mlp_backward": sh_mlp.sh_mlp_backward}
    for c in counters.values():
        c.launches = 0
    losses, psnrs, per_step = [], [], []
    warm_from = TRAIN_STEPS - 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_warm = None
    prof = None
    for i in range(TRAIN_STEPS):
        if i == warm_from:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        if kind == "vm" and i == VM_PROFILED_STEPS.start:
            prof = step_profiler()
        before = {k: c.launches for k, c in counters.items()}
        if i == TRAIN_STEPS - 1:
            state, metrics = capture_step_operands(
                lambda: system.train_step(state), "", check=check_vm_step if kind == "vm" else None)
        else:
            state, metrics = system.train_step(state)
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        if min(delta.values()) < 1:
            raise AssertionError(f"step {i}: a kernel was not launched: {delta}")
        if i % system.grid_update_every == 0 and delta[f"{density}_forward"] < 2:
            raise AssertionError(f"step {i}: the grid update did not run {density}: {delta}")
        per_step.append(delta)
        if prof is not None and i == VM_PROFILED_STEPS.stop - 1:
            VM_RUN.update(prof(len(VM_PROFILED_STEPS)))
            prof = None
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
    if kind == "vm":
        VM_RUN.update(untrained=untrained["psnr"], trained=trained["psnr"], rays_per_s=rays_per_s,
                      ms_per_step=warm_s / 100 * 1e3, loss=(first, last))
        vm_mesh_phase(device, system, state, smi)
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
            "cp_product_jac_forward": cpp.cp_product_jac,
            "cp_product_jac_backward": cpp.cp_product_jac_backward,
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


def jac_kernel(model):
    """(tag, counter prefix) of the product-with-Jacobian kernels a NeuS
    model's encoding runs: K11/K12 stacked, K7/K8 without a basis, else
    K9/K10."""
    enc = model.geometry.encoding.encoding
    if enc.stack_scales:
        return "neus-stacked", "cp_jac_stacked"
    if enc.spec.n_features == 0:
        return "neus-raw", "cp_product_jac"
    return "neus", "cp_jac_basis"


def neus_train_phase(device, smi, config=NEUS_CONFIG):
    """The bench NeuS (or the stacked NeuS: K11/K12 for K9/K10, or the raw
    NeuS: K7/K8) trained through NeuSSystem.train_step for NEUS_STEPS steps
    (8,192 rays and 262,144 packed samples per step)."""
    system, val = neus_system(device, config=config)
    state = system.init_state(seed=SEED)
    model, params = system.model, state["params"]
    geo = model.geometry
    tag, jac = jac_kernel(model)
    assert geo.use_jac and geo.encoding.encoding.grad_mode == "fast" and model.texture.fused
    assert system.train_capacity == N_FULL, system.train_capacity

    # the untrained model against the grid its first (warmup) update gives
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    occ0 = model.update_occupancy(params, state["occ"], gen, warmup=True)
    untrained = system.evaluate_image({"params": params, "occ": occ0}, 0, data=val)
    print(f"[{tag}] untrained val view: PSNR {untrained['psnr']:.3f} dB", flush=True)

    # before the first step: a backward, finite gradients everywhere, zero
    # only on the CP tables and bases, if any (the sphere init's first layer
    # is zero beyond the xyz rows, so d out / d enc = 0)
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t_warm = None
    for i in range(NEUS_STEPS):
        if i == warm_from:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        before = {k: c.launches for k, c in counters.items()}
        if i == NEUS_STEPS - 1:
            state, metrics = capture_step_operands(lambda: system.train_step(state), "",
                                                   check=check_step_kernels)
        else:
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
    peak = torch.cuda.max_memory_allocated()
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
          f"the last {n_warm} steps; peak device memory over the {NEUS_STEPS} steps "
          f"{peak / 2**30:.2f} GiB ({smi})", flush=True)
    return system, state, val, per_step[1], totals, rays_per_s


def neus_render_phase(device, system, state, val, smi):
    """One 256x256 val view of the trained NeuS through evaluate_image (the
    counters read around it: K9, or K11 for the stacked NeuS and K7 for the
    raw one, in eval mode, K3, no backward), again warm through
    render_image, and one composited 4,096-ray chunk from the kernels on the
    card against the same chunk from the plain versions on the CPU."""
    from instant_nsr_pl_tpu_torch.ops.ray import get_rays

    tag, jac = jac_kernel(system.model)
    tag += "-render"

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
    per_chunk = 1 if jac == "cp_jac_stacked" else 2  # one launch, or one per scale
    assert launches[f"{jac}_forward"] >= per_chunk * chunks, launches
    assert launches["sh_mlp_forward"] >= chunks, launches
    assert all(launches[k] == 0 for k in launches if k.endswith("_backward")), launches
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
    # the trained SDF's level set on a 64^3 grid of the scene's cube (K5)
    from instant_nsr_pl_tpu_torch.models.isosurface import _eval_level_grid

    r = system.model.radius
    vals = _eval_level_grid(system.model.geometry, state["params"]["geometry"],
                            np.full(3, -r, np.float32), np.full(3, r, np.float32), 64, N_FULL,
                            device)
    print(f"[{tag}] trained SDF on a 64^3 grid: min {vals.min():.4f}, max {vals.max():.4f}, "
          f"{(vals < 0).float().mean():.4%} of the points below 0", flush=True)
    return launches, n_rays / view_s, n_rays / warm_s


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.detach().to(device)


def check_step_kernels(key, calls):
    """The kernels of a NeuS step on their own operands (each recorded
    launch: ray-ordered samples, and for the finite-difference step their
    stencils), against their plain versions: K6 (the step's residual and
    cotangent) within 2.5e-2 * max|plain|; K5 (prod and vsave), K9 and K11
    (vsave and gdsave) equal to the bit, and K9's and K11's enc and jac within
    2e-2 * max|plain|; HG3's feat equal to HG1's to the bit and its jac within
    2e-2 * max|plain|, HG4 within the hash gradient limits
    (``hash_grad_limits``); HG1 within 1e-5 * max|plain| and HG2 within the
    hash gradient limits; K3 within 2e-2 * max|plain| (its hsave differing
    in at most 1e-3 of its entries, as in ``kernel_phase``) and K4 within
    2.5e-2 * max|plain| per gradient."""
    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp
    from instant_nsr_pl_tpu_torch.ops import cp_stacked as cps
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg
    from instant_nsr_pl_tpu_torch.ops import sh_mlp as sh

    def equal(tag, label, a, b):
        if not torch.equal(a, b):
            frac = float((a != b).float().mean())
            raise AssertionError(f"{tag}: {label} differs from the plain version's in "
                                 f"{frac:.2e} of its entries")

    for k, (args, kwargs) in enumerate(calls):
        if key.startswith("cp_product_backward"):
            got = cpp.cp_product_backward_launch(*args)
            torch.cuda.synchronize()
            ref = cpp.cp_product_backward_plain(*args)
            tag = f"{key} step launch {k} (R={args[4]}, N={args[1].shape[1]})"
            for label, a, b in zip(("d lines", "d u"), got, ref):
                compare(f"{tag} {label}", a, b, rel=2.5e-2)
        elif key.startswith("cp_product_forward"):
            got = cpp.cp_product_launch(*args, **kwargs)
            torch.cuda.synchronize()
            ref = cpp.cp_product_plain(*args, save_residuals=True)
            tag = f"{key} step launch {k} (R={args[2]}, N={args[1].shape[1]})"
            for label, a, b in zip(("prod", "vsave"), got, ref):
                equal(tag, label, a, b)
            print(f"[kernel] {tag}: prod and vsave equal the plain version's to the bit",
                  flush=True)
        elif key.startswith(("cp_jac_basis_forward", "cp_jac_stacked_forward")):
            stacked = key.startswith("cp_jac_stacked")
            launch = cps.cp_jac_basis_stacked_launch if stacked else cpp.cp_product_jac_basis_launch
            plain = cps.cp_jac_basis_stacked_plain if stacked else cpp.cp_product_jac_basis_plain
            got = launch(*args, **kwargs)
            torch.cuda.synchronize()
            ref = plain(*args, save_residuals=True)
            tag = f"{key} step launch {k} (R={args[3]}, N={args[2].shape[1]})"
            for label, a, b in zip(("vsave", "gdsave"), got[2:], ref[2:]):
                equal(tag, label, a, b)
            for label, a, b in zip(("enc", "jac"), got[:2], ref[:2]):
                compare(f"{tag} {label}", a, b)
        elif key.startswith("hashgrid_jac_forward"):
            table, x, spec = args[:3]
            mask = args[3] if len(args) > 3 else kwargs.get("level_mask")
            feat, jac = hg.hashgrid_jac_forward_launch(*args, **kwargs)
            hg1 = hg.hashgrid_forward_launch(table, x, spec, mask)
            torch.cuda.synchronize()
            tag = f"{key} step launch {k} (N={x.reshape(-1, 3).shape[0]})"
            equal(tag, "feat (against HG1)", feat, hg1)
            compare(f"{tag} jac", jac, hg.hashgrid_jac_forward_plain(*args, **kwargs)[1])
        elif key.startswith("hashgrid_jac_backward"):
            got = hg.hashgrid_jac_backward_launch(*args, **kwargs)
            torch.cuda.synchronize()
            ref = hg.hashgrid_jac_backward_plain(*args, **kwargs)
            spec = args[4]
            tag = f"{key} step launch {k} (N={args[1].reshape(-1, 3).shape[0]})"
            hash_grad_limits(tag, spec, got, ref)
        elif key.startswith("hashgrid_forward"):
            got = hg.hashgrid_forward_launch(*args, **kwargs)
            torch.cuda.synchronize()
            tag = f"{key} step launch {k} (N={args[1].reshape(-1, 3).shape[0]})"
            compare(tag, got, hg.hashgrid_encode(*args, **kwargs), rel=1e-5)
        elif key.startswith("hashgrid_backward"):
            got = hg.hashgrid_backward_launch(*args, **kwargs)
            torch.cuda.synchronize()
            ref = hg.hashgrid_backward_plain(*args, **kwargs)
            tag = f"{key} step launch {k} (N={args[1].reshape(-1, 3).shape[0]})"
            hash_grad_limits(tag, args[3], got, ref)
        elif key.startswith("sh_mlp_forward"):
            ops, feats, dirs, spec, degree = args[:5]
            params, n_pre = next((p, n) for ws, p, n in SH_PACKS if ws is ops[0])
            got, hsave = sh.sh_mlp_launch(*args, **kwargs)
            torch.cuda.synchronize()
            ref, ref_h = sh.sh_mlp_forward_plain(params, feats, dirs, spec, degree, n_pre,
                                                 save_residuals=True)
            tag = f"{key} step launch {k} (N={feats.reshape(-1, feats.shape[-1]).shape[0]})"
            compare(f"{tag} out", got, ref)
            frac = float((hsave != ref_h).float().mean())
            if frac > 1e-3:  # bf16 roundings of f32 sums in another order (kernel_phase)
                raise AssertionError(f"{tag}: hsave differs in {frac:.2e} of its entries")
        elif key.startswith("sh_mlp_backward"):
            got = sh.sh_mlp_backward_launch(*args)
            torch.cuda.synchronize()
            ref = sh.sh_mlp_backward_plain(*args)
            tag = f"{key} step launch {k} (N={args[0].reshape(-1, args[0].shape[-1]).shape[0]})"
            for label, a, b in zip(("d ws", "d bs", "d features"), got, ref):
                compare(f"{tag} {label}", a, b, rel=2.5e-2)


def neus_fd_phase(device):
    """The bench NeuS with geometry.grad_type: finite_difference (and the
    curvature loss on its Laplacian) for FD_STEPS steps: K5 and K6 run the
    stencil's SDF on every step, all gradients are finite, the tables get a
    gradient after the first update, the loss stays finite; the last step's
    K6 launches are checked and timed on their own operands."""
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
        if i == FD_STEPS - 1:
            state, metrics = capture_step_operands(lambda: system.train_step(state), "",
                                                   check=check_step_kernels)
        else:
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
    print(f"[neus-fd] {FD_STEPS} steps in {wall:.2f} s (the last with K6 checked and timed); "
          f"launches {totals}; one step {per_step[1]}; {n_leaves} parameter tensors with "
          f"finite, non-zero gradients after the first update; loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; trajectory {[round(v, 6) for v in losses]}", flush=True)
    assert np.isfinite(losses).all(), "the loss went non-finite"
    return per_step[1], totals


def trainer_phase(device, system, state, smi):
    """The trained raw NeuS through the Trainer's test, predict and export
    (``trainer.py``), as ``launch.py --test`` / ``--predict`` / ``--export``
    run them, into ``exp/chip_smoke/<config name>/save``; the launch counters
    set to 0 just before each and read just after. Test: the four 256x256
    test views (K7 in eval mode, K3) with their PNGs and metric sidecars,
    test/psnr, then the mesh. Predict: the eight train-camera views. Export:
    the 128^3 two-stage marching pass (K5 in the level grid, per scale and
    chunk; the fine pass only where the coarse one found a surface), the
    vertex colours through the analytic normal (K7 in eval mode, no K8), each
    timed by stage, of the trained state and of the same model's sphere-init
    state (the seed's parameters before training), whose level set is a
    sphere: there a non-empty mesh with valid indices and finite colours in
    [0, 1], and one chunk of vertex colours from the kernels against the
    plain versions on the CPU within 2e-2."""
    import instant_nsr_pl_tpu_torch.models.isosurface as iso_mod
    from instant_nsr_pl_tpu_torch.registry import datasets
    from instant_nsr_pl_tpu_torch.trainer import Trainer
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj

    cfg = system.config
    exp_dir = os.path.join(ROOT, "exp", "chip_smoke", cfg.name)
    trainer = Trainer(cfg, exp_dir)
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    step = int(state["step"])
    counters = neus_counters()
    launches, walls = {}, {}

    def run(phase, fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[phase] = time.perf_counter() - t0
        launches[phase] = {k: c.launches for k, c in counters.items() if c.launches}
        print(f"[{phase}] {walls[phase]:.2f} s, launches {launches[phase]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        return result

    n_scales = len(cfg.model.geometry.xyz_encoding_config.resolutions)
    view_chunks = -(-system.w * system.h // system.eval_chunk_rays)
    iso = cfg.model.geometry.isosurface
    pass_chunks = -(-(int(iso.resolution) ** 3) // int(iso.chunk))
    colour_chunk = min(int(cfg.export.chunk_size), 262144)

    def obj_faces(at_step):
        path = os.path.join(trainer.save_dir, f"it{at_step}-neus.obj")
        return len(load_obj(path)["t_pos_idx"])

    test_dir = os.path.join(trainer.save_dir, f"it{step}-test")
    if os.path.isdir(test_dir):  # a fresh test: no cached views from an earlier run
        for f in os.listdir(test_dir):
            os.remove(os.path.join(test_dir, f))
    psnr = run("test", lambda: trainer.test(system, dm, state))
    n_test = int(cfg.dataset.get("n_test", 4))
    names = sorted(os.listdir(test_dir))
    assert names == sorted(f"{i}.{e}" for i in range(n_test) for e in ("png", "json")), names
    assert math.isfinite(psnr), psnr
    k = launches["test"]
    passes = 2 if obj_faces(step) else 1  # the fine pass runs where the coarse found a surface
    assert k["cp_product_jac_forward"] >= n_test * n_scales * view_chunks, k
    assert k["cp_product_forward"] == n_scales * passes * pass_chunks, k
    assert k["sh_mlp_forward"] >= n_test * view_chunks, k
    print(f"[test] test/psnr {psnr:.3f} dB over {n_test} views ({smi})", flush=True)

    n_pred = run("predict", lambda: trainer.predict(system, dm, state))
    pred = sorted(os.listdir(os.path.join(trainer.save_dir, f"it{step}-predict")))
    assert n_pred == system.n_images and pred == sorted(f"{i}.png" for i in range(n_pred)), pred
    assert launches["predict"]["cp_product_jac_forward"] >= n_pred * n_scales * view_chunks

    # export, timed by stage: the level grid (K5), marching (MT1 / MT2),
    # the vertex colours (K7 eval + K3) and the rest (the OBJ); the coarse
    # level grid's minimum and share below the level set
    model = system.model
    level_fn, march_fn = iso_mod._eval_level_grid, iso_mod.marching_tetrahedra
    colour_fn = model.vertex_colors
    stages = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage[key] += time.perf_counter() - t0
            if key == "level grid" and "level min" not in stage:
                stage["level min"] = float(out.min())
                stage["inside share"] = float((out < 0).float().mean())
            return out
        return wrapper

    def export(phase, st):
        nonlocal stage
        stage = stages[phase] = {"level grid": 0.0, "marching": 0.0, "vertex colours": 0.0}
        iso_mod._eval_level_grid = timed("level grid", level_fn)
        iso_mod.marching_tetrahedra = timed("marching", march_fn)
        model.vertex_colors = timed("vertex colours", colour_fn)
        try:
            mesh = run(phase, lambda: trainer.export(system, st))
        finally:
            iso_mod._eval_level_grid, iso_mod.marching_tetrahedra = level_fn, march_fn
            del model.vertex_colors  # the class's method again
        v, f = mesh["v_pos"], mesh["t_pos_idx"]
        k = launches[phase]
        rest = walls[phase] - stage["level grid"] - stage["marching"] - stage["vertex colours"]
        print(f"[{phase}] step {int(st['step'])}: {len(v)} vertices, {len(f)} faces; coarse level "
              f"grid min {stage['level min']:.4f}, {stage['inside share']:.4%} below 0; level "
              f"grid {stage['level grid']:.3f} s, marching {stage['marching']:.3f} s (card), "
              f"vertex colours {stage['vertex colours']:.3f} s, the rest (OBJ) {rest:.3f} s; "
              f"launches {k} ({smi})", flush=True)
        passes = 2 if len(f) else 1
        assert k.get("cp_product_forward", 0) == n_scales * passes * pass_chunks, k
        assert k.get("cp_product_jac_forward", 0) == n_scales * -(-len(v) // colour_chunk), k
        assert not any(name.endswith("_backward") for name in k), k
        assert obj_faces(int(st["step"])) == len(f)
        return mesh

    stage = None
    export("export", state)
    init = system.init_state(seed=SEED)  # the sphere init: the level set is a sphere
    mesh = export("export_init", init)
    v, f, rgb = mesh["v_pos"], mesh["t_pos_idx"], mesh["v_rgb"]
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v), "empty or broken mesh"
    assert np.isfinite(rgb).all() and rgb.min() >= 0.0 and rgb.max() <= 1.0

    # one chunk of vertex colours: kernels on the card, plain versions on the CPU
    pts = torch.from_numpy(v[:colour_chunk])
    with torch.no_grad():
        on_card = model.vertex_colors(init["params"], pts.to(device)).cpu()
        on_cpu = model.vertex_colors(_to(init["params"], torch.device("cpu")), pts)
    err = float((on_card - on_cpu).abs().max())
    print(f"[export_init] vertex colours of {len(pts)} vertices: max|kernels - plain| = "
          f"{err:.3e} (limit 2e-2)", flush=True)
    if not err <= 2e-2:
        raise AssertionError("vertex colours: kernels and plain versions disagree")
    return launches, stages, walls


def sphere_extraction_phase(spheres, device):
    """The port's two-stage extraction (``models/isosurface.py``) of the
    scene's own sphere-union SDF at 128^3, the level grid handed over as a
    CUDA tensor: every vertex within one voxel of a sphere surface."""
    from instant_nsr_pl_tpu_torch.datasets.synthetic import scene_sdf
    from instant_nsr_pl_tpu_torch.models.isosurface import extract_isosurface

    spheres = tuple((tuple(s[0:3]), float(s[3]), tuple(s[4:7])) for s in spheres)

    class SceneSDF:
        radius = 1.5
        config = {"isosurface": {"resolution": 128, "chunk": 262144, "threshold": 0.0}}

        def forward_level(self, params, points, step=None):
            return torch.as_tensor(scene_sdf(points.cpu().numpy(), spheres), device=points.device)

    mesh = extract_isosurface(SceneSDF(), None, device)
    v = mesh["v_pos"]
    dist = np.min([np.abs(np.linalg.norm(v - np.float32(c), axis=1) - r) for c, r, _ in spheres],
                  axis=0)
    voxel = 2 * 1.5 / 127
    print(f"[sphere-sdf] {len(v)} vertices, {len(mesh['t_pos_idx'])} faces; max distance to a "
          f"sphere surface {dist.max():.3e} (one coarse voxel {voxel:.3e})", flush=True)
    assert len(v) > 0 and dist.max() <= voxel, "the extracted scene surface is off"


# ---------------------------------------------------------------------------
# slice 6: the hash grid (HG1/HG2), the cp_big instantiations, the probes,
# the hash NeRF and the repo's configs/nerf-synthetic.yaml
# ---------------------------------------------------------------------------

HASH_CONFIG = os.path.join(CONFIGS, "nerf-hash-synthetic.yaml")
REPO_NERF_CONFIG = os.path.join(ROOT, "configs", "nerf-synthetic.yaml")
LAUNCHER_STEPS = 300
CP_BIG_STEPS = 20
CP_BIG = {"otype": "CP", "n_components": 128, "resolutions": [64, 512, 4096], "n_features": 16}
PROBE_CHECK_M = 1 << 18


def hash_spec():
    """The bench hash grid (bench.py _ENCODINGS["hash"], :99-103)."""
    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec

    return HashGridSpec(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                        base_resolution=16, per_level_scale=1.447269237440378)


def hash_kernel_phase(device):
    """HG1 (the hash encoding forward) and HG2 (its table gradient, and the
    position gradient on request) at the bench hash shape (16 levels, F=2,
    2^19 rows per hashed level: a 6,299,960-row table), N=262,144 and
    262,107, against their plain versions on the same CUDA tensors: HG1
    within rtol 1e-5 (it should equal the plain version to the bit: both
    round x*s+0.5 and the corner sum as fused multiply-adds), with and
    without a level mask; HG2's table gradient within 1e-5 x max|plain| per
    level (float32 atomics sum in another order each run), its position
    gradient within 1e-4 x max|plain|; then timed."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = hash_spec()
    gen = torch.Generator().manual_seed(SEED + 13)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(device)  # values of order 1
    x = torch.rand((N_FULL, 3), generator=gen)
    x[:6] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.75],
                          [0.0, 1.0, 0.5], [1.0, 0.0, 0.125], [0.999999, 1e-7, 0.5]])
    x = x.to(device)
    ct = torch.randn((N_FULL, spec.n_output_dims), generator=gen).to(device)
    mask = torch.tensor([1.0] * 10 + [0.5, 0.0, 1.0, 1.0, 0.0, 1.0]).to(device)
    f, n_levels = spec.n_features_per_level, spec.n_levels
    errs = {"hashgrid_forward": [], "hashgrid_backward": []}
    for n in (N_RAGGED, N_FULL):
        xn, ctn = x[:n], ct[:n].contiguous()
        for m in (None, mask):
            tag = f"N={n}" + (" masked" if m is not None else "")
            got = hg.hashgrid_forward_launch(table, xn, spec, m)
            torch.cuda.synchronize()
            ref = hg.hashgrid_encode(table, xn, spec, m)
            same = float((got == ref).float().mean())
            err = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            print(f"[kernel] hashgrid_forward {tag}: {same:.6%} of the entries equal the plain "
                  f"version's to the bit; max|kernel - plain| {err:.3e} (limit 1e-5*max|plain| "
                  f"= {tol:.3e})", flush=True)
            if not err <= tol:
                raise AssertionError("hashgrid_forward disagrees with its plain version")
            errs["hashgrid_forward"].append(err)
            dt, dx = hg.hashgrid_backward_launch(table, xn, ctn, spec, m, with_dx=True)
            dt_only, no_dx = hg.hashgrid_backward_launch(table, xn, ctn, spec, m)
            torch.cuda.synchronize()
            assert no_dx is None
            rt, rx = hg.hashgrid_backward_plain(table, xn, ctn, spec, m, with_dx=True)
            for lv in range(n_levels):
                sl = slice(spec.level_offsets[lv], spec.level_offsets[lv] + spec.level_sizes[lv])
                for got_t in (dt, dt_only):
                    e = float((got_t[sl] - rt[sl]).abs().max())
                    t = 1e-5 * float(rt[sl].abs().max())
                    if not e <= t:
                        raise AssertionError(f"hashgrid_backward {tag} level {lv}: {e:.3e} > "
                                             f"{t:.3e}")
            errs["hashgrid_backward"].append(compare(f"hashgrid_backward {tag} d table", dt, rt,
                                                     rel=1e-5))
            errs["hashgrid_backward"].append(compare(f"hashgrid_backward {tag} d x", dx, rx,
                                                     rel=1e-4))
    # ray-ordered samples (512 rays of 512, as a training step packs them):
    # the coarse levels' rows repeat within a warp and HG2 merges them
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    x_ray = positions(gen, "ray", N_FULL).to(device)
    for m in (None, mask):
        tag = "ray-ordered" + (" masked" if m is not None else "")
        dt, dx = hg.hashgrid_backward_launch(table, x_ray, ct, spec, m, with_dx=True)
        torch.cuda.synchronize()
        rt, rx = hg.hashgrid_backward_plain(table, x_ray, ct, spec, m, with_dx=True)
        for lv in range(n_levels):
            sl = slice(spec.level_offsets[lv], spec.level_offsets[lv] + spec.level_sizes[lv])
            e = float((dt[sl] - rt[sl]).abs().max())
            t = 1e-5 * float(rt[sl].abs().max())
            if not e <= t:
                raise AssertionError(f"hashgrid_backward {tag} level {lv}: {e:.3e} > {t:.3e}")
        errs["hashgrid_backward"].append(compare(f"hashgrid_backward {tag} d table", dt, rt,
                                                 rel=1e-5))
        errs["hashgrid_backward"].append(compare(f"hashgrid_backward {tag} d x", dx, rx,
                                                 rel=1e-4))
    # through the autograd Function (the training mode: the same HG1 launch)
    t_req = table.clone().requires_grad_(True)
    out = hg.hashgrid_encode_fast(t_req, x, spec)
    out.backward(ct)
    torch.cuda.synchronize()
    compare("hashgrid_encode_fast d table", t_req.grad,
            hg.hashgrid_backward_plain(table, x, ct, spec)[0], rel=1e-5)

    n = N_FULL
    hashed = sum(spec.level_hashed)
    table_bytes = spec.total_params * f * 4
    fwd_bytes = n * (12 + n_levels * f * 4) + table_bytes
    bwd_bytes = n * (12 + n_levels * f * 4) + table_bytes
    # the row-major (T, F) table: one 32-byte sector per hashed corner (a
    # feature-major (F, T) table would take one per corner and feature row)
    sectors = n * hashed * 8 * 32
    sector_ft_ms = bound(sectors * f, 0, 0)[0]
    atomics = n * n_levels * 8  # HG2: one vector atomic per corner, before the merge
    bwd_sector_ms = bound(sectors, 0, 0)[0]
    ms = time_ms(lambda: hg.hashgrid_forward_launch(table, x, spec))
    ms_train = time_ms(lambda: hg.hashgrid_encode_fast(t_req, x, spec))
    plain_ms = time_ms(lambda: hg.hashgrid_encode(table, x, spec), reps=5, inner=2)
    bms = time_ms(lambda: hg.hashgrid_backward_launch(table, x, ct, spec))
    bms_dx = time_ms(lambda: hg.hashgrid_backward_launch(table, x, ct, spec, with_dx=True))
    bdev = device_ms(lambda: hg.hashgrid_backward_launch(table, x, ct, spec))
    bdev_dx = device_ms(lambda: hg.hashgrid_backward_launch(table, x, ct, spec, with_dx=True))
    composed_ms = composed_hash(device, spec, x, ct)
    bplain_ms = time_ms(lambda: hg.hashgrid_backward_plain(table, x, ct, spec), reps=5, inner=2)
    fwd_bound, _ = bound(fwd_bytes, 0, n * n_levels * 8 * (6 + 2 * f))
    bwd_bound, _ = bound(bwd_bytes, 0, n * n_levels * 8 * (6 + f))
    sector_ms = bound(sectors, 0, 0)[0]
    print(f"[kernel] hashgrid_forward: {ms:.4f} ms eval, {ms_train:.4f} ms through the autograd "
          f"op (plain {plain_ms:.3f} ms; bound {fwd_bound:.4f} ms by compulsory bytes, "
          f"{sector_ms:.4f} ms by 32-byte sectors of the hashed levels' (T, F) rows, "
          f"{sector_ft_ms:.4f} ms in an (F, T) layout) at N={n}", flush=True)
    print(f"[kernel] hashgrid_backward: {bms:.4f} ms, {bms_dx:.4f} ms with d x (device "
          f"{bdev:.4f} / {bdev_dx:.4f} ms; plain {bplain_ms:.3f} ms; precomputed taps and one "
          f"index_add_ per feature {composed_ms:.4f} ms; bound {bwd_bound:.4f} ms by compulsory "
          f"bytes, {bwd_sector_ms:.4f} ms by sectors; {atomics} corner updates before the "
          f"merge) at N={n}", flush=True)
    note = "no single PyTorch call hashes and interpolates (or scatters the hashed taps)"
    common = {"route": "cuda", "launches": 0, "library_ms": None, "library_note": note, "n": n,
              "bound_by": "bytes", "bound_sectors_ms": sector_ms}
    return [
        {**common, "name": "hashgrid_forward",
         "source": "instant_nsr_pl_tpu_torch/csrc/hashgrid_fwd.cu",
         "replaces": "instant_nsr_pl_tpu/ops/hashgrid.py:584 (_encode_with_taps, XLA)",
         "max_abs_err": max(errs["hashgrid_forward"]), "ms": ms, "ms_train": ms_train,
         "plain_ms": plain_ms, "bound_ms": fwd_bound, "bound_sectors_ft_ms": sector_ft_ms},
        {**common, "name": "hashgrid_backward",
         "source": "instant_nsr_pl_tpu_torch/csrc/hashgrid_bwd.cu",
         "replaces": "instant_nsr_pl_tpu/ops/hashgrid.py:652 (_encode_fast_bwd, XLA)",
         "max_abs_err": max(errs["hashgrid_backward"]), "ms": bms, "ms_with_dx": bms_dx,
         "device_ms": bdev, "device_ms_with_dx": bdev_dx, "composed_ms": composed_ms,
         "plain_ms": bplain_ms, "bound_ms": bwd_bound, "corner_updates": atomics,
         "bound_sectors_ms": bwd_sector_ms},
    ]


def cp_big_kernel_phase(device):
    """The ``bench.py --encoding cp_big`` instantiations (C=128, R=(64, 512,
    4096), F=16): K1 (training mode) and K2 with the bench NeRF head
    48->64->16 at N=262,144 and 262,107 against their plain versions (vsave
    bit for bit, the output within 2e-2, gradients within 2.5e-2 of
    max|plain|), then timed; K5-K10 per scale through ``cp_kernel_phase``."""
    from instant_nsr_pl_tpu_torch.ops import cp_mlp
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
    from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init

    c, f, res = CP_BIG["n_components"], CP_BIG["n_features"], tuple(CP_BIG["resolutions"])
    gen = torch.Generator().manual_seed(SEED + 17)
    cp_spec = CPSpec(c, res, f)
    d_spec = MLPSpec(dim_in=3 * f, dim_out=16, n_neurons=64, n_hidden_layers=1)
    cp_params = cp_init(gen, cp_spec, device)
    d_layers = with_biases(mlp_init(gen, d_spec, device), gen, device)
    x = torch.rand((N_FULL, 3), generator=gen) * 1.1 - 0.05
    x[:4] = torch.tensor([[0.0, 1.0, 0.5], [1.0, 0.0, -0.05], [1.05, 0.5, 1.0], [0.5, 0.5, 0.5]])
    x = x.to(device)
    d_dout = torch.randn((N_FULL, 16), generator=gen).to(device)
    ops = cp_mlp.cp_mlp_operands(cp_params, d_layers, cp_spec, d_spec)
    errs = {"cp_mlp_forward": [], "cp_mlp_backward": []}
    for n in (N_RAGGED, N_FULL):  # the timing below reuses the N_FULL arguments
        xn = x[:n]
        tag = f"cp_big N={n}"
        out, vsave, hsave = cp_mlp.cp_mlp_launch(ops, xn, cp_spec, d_spec, train=True)
        torch.cuda.synchronize()
        ref, ref_v, ref_h = cp_mlp.cp_mlp_forward_plain(cp_params, d_layers, xn, cp_spec, d_spec,
                                                        save_residuals=True)
        errs["cp_mlp_forward"].append(compare(f"cp_mlp_forward {tag}", out, ref))
        if not torch.equal(vsave, ref_v) or float((hsave != ref_h).float().mean()) > 1e-3:
            raise AssertionError(f"cp_mlp_forward {tag}: residuals disagree")
        if not torch.equal(cp_mlp.cp_mlp_launch(ops, xn, cp_spec, d_spec)[0], out):
            raise AssertionError(f"cp_mlp_forward {tag}: eval and training mode disagree")
        bwd_args = (xn, vsave, hsave, d_dout[:n].contiguous(), ops[1], ops[2], cp_spec, d_spec)
        got = cp_mlp.cp_mlp_backward_launch(*bwd_args)
        torch.cuda.synchronize()
        ref = cp_mlp.cp_mlp_backward_plain(*bwd_args)
        for label, a, b in zip([f"d line_{s}" for s in range(len(res))] + ["d basis", "dW", "db"],
                               [*got[0], *got[1:]], [*ref[0], *ref[1:]]):
            errs["cp_mlp_backward"].append(compare(f"cp_mlp_backward {tag} {label}", a, b,
                                                   rel=2.5e-2))
    n, e_dim, w = N_FULL, 3 * f, 64
    line_entries = sum(3 * r * c for r in res)
    mlp_macs = _mlp_macs([e_dim, w, 16])
    timed = {
        "cp_mlp_forward": (
            "cp_mlp_fwd.cu", "cp_mlp_pallas.py:267",
            lambda: cp_mlp.cp_mlp_launch(ops, x, cp_spec, d_spec, train=True),
            lambda: cp_mlp.cp_mlp_forward_plain(cp_params, d_layers, x, cp_spec, d_spec,
                                                save_residuals=True),
            n * (12 + 16 * 4 + 3 * 3 * c * 2 + w * 2) + line_entries * 2 + 3 * c * f * 2
            + (e_dim + w) * w * 2, n * 2 * (3 * c * f + mlp_macs), n * 2 * 3 * 3 * c),
        "cp_mlp_backward": (
            "cp_mlp_bwd.cu", "cp_mlp_pallas.py:353",
            lambda: cp_mlp.cp_mlp_backward_launch(*bwd_args),
            lambda: cp_mlp.cp_mlp_backward_plain(*bwd_args),
            n * (12 + 3 * 3 * c * 2 + w * 2 + 16 * 4) + line_entries * 4 + 3 * c * f * 6
            + (e_dim + w) * w * 6, n * 2 * (3 * 3 * c * f + 2 * mlp_macs), n * 3 * c * 8),
    }
    entries = []
    for name, (src, replaces, kern, plain, n_bytes, bf16_ops, f32_ops) in timed.items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain, reps=3, inner=2)
        bound_ms, bound_by = bound(n_bytes, bf16_ops, f32_ops)
        print(f"[kernel] {name} cp_big: {ms:.4f} ms (plain {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by}) at N={n}", flush=True)
        entries.append({
            **({"composed_ms": composed_backward("cp", device, c=c, s_count=len(res)),
                "device_ms": device_ms(kern)} if name == "cp_mlp_backward" else
               {"ms_eval": time_ms(lambda: cp_mlp.cp_mlp_launch(ops, x, cp_spec, d_spec))}),
            "name": f"{name}@cp_big", "route": "cuda",
            "source": f"instant_nsr_pl_tpu_torch/csrc/{src}",
            "replaces": f"instant_nsr_pl_tpu/ops/{replaces}", "launches": 0,
            "max_abs_err": max(errs[name]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function", "n": n,
            "shape": f"C={c}, R={res}, F={f}, MLP {e_dim}->{w}->16",
        })
    return entries + cp_kernel_phase(device, c, f, res, (), "@cp_big")


def cp_big_train_phase(device, smi):
    """The bench NeRF and the bench NeuS with ``bench.py --encoding
    cp_big``'s encoding, built for the card (the instantiation check at
    build time passes) and trained CP_BIG_STEPS steps each through
    ``train_step``, the launch counters read around each run: NeRF K1-K4 and
    NeuS K3/K4, K9/K10 on every step (K5 in the grid updates); the same
    NeuS with the raw products (``n_features: 0``: K7/K8 on every step) and
    with finite differences (K5/K6 on every step); finite losses. A CP shape
    without kernels is refused when the model is built."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.registry import datasets, systems

    counts = {}
    per_step_kernels = {
        "nerf": ("cp_mlp_forward", "cp_mlp_backward", "sh_mlp_forward", "sh_mlp_backward"),
        "neus": ("sh_mlp_forward", "sh_mlp_backward", "cp_jac_basis_forward",
                 "cp_jac_basis_backward"),
        "neus_raw": ("cp_product_jac_forward", "cp_product_jac_backward"),
        "neus_fd": ("cp_product_forward", "cp_product_backward"),
    }
    for kind, kernels in per_step_kernels.items():
        raw = bench_config(NEUS_CONFIG if kind.startswith("neus") else BENCH_CONFIG)
        enc = dict(CP_BIG, include_xyz=True) if kind.startswith("neus") else dict(CP_BIG)
        if kind == "neus_raw":
            enc["n_features"] = 0
        if kind == "neus_fd":
            raw["model"]["geometry"]["grad_type"] = "finite_difference"
        raw["model"]["geometry"]["xyz_encoding_config"] = enc
        cfg = config_from_dict(raw)
        dm = datasets.make(cfg.dataset.name, cfg.dataset)
        dm.setup("fit")
        system = systems.make(cfg.system.name, cfg)
        system.setup_data(dm.train)
        state = system.init_state(seed=SEED)
        if kind == "nerf":
            assert system.model.geometry.encoding_with_network.fused
            counters = {"cp_mlp_forward": cp_mlp.cp_mlp_forward,
                        "cp_mlp_backward": cp_mlp.cp_mlp_backward,
                        "sh_mlp_forward": sh_mlp.sh_mlp_forward,
                        "sh_mlp_backward": sh_mlp.sh_mlp_backward}
        else:
            counters = neus_counters()
        for c in counters.values():
            c.launches = 0
        losses = []
        for i in range(CP_BIG_STEPS):
            before = {k: c.launches for k, c in counters.items()}
            if i == CP_BIG_STEPS - 1:
                state, metrics = capture_step_operands(lambda: system.train_step(state),
                                                       "@cp_big", check=check_step_kernels)
            else:
                state, metrics = system.train_step(state)
            delta = {k: c.launches - before[k] for k, c in counters.items()}
            if min(delta[k] for k in kernels) < 1:
                raise AssertionError(f"cp_big {kind} step {i}: a kernel was not launched: {delta}")
            losses.append(float(metrics["train/loss"]))
        assert np.isfinite(losses).all(), losses
        counts[kind] = {k: c.launches for k, c in counters.items()}
        print(f"[cp_big-{kind}] {CP_BIG_STEPS} steps, loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
              f"launches {counts[kind]} ({smi})", flush=True)
        del system, state
        torch.cuda.empty_cache()
    # a CP width with no instantiation is refused when the model is built
    raw = bench_config(BENCH_CONFIG)
    raw["model"]["geometry"]["xyz_encoding_config"]["n_components"] = 96
    cfg = config_from_dict(raw)
    try:
        systems.make(cfg.system.name, cfg).init_state(seed=SEED)
    except ValueError as e:
        print(f"[cp_big] C=96 refused at build time: {str(e)[:120]}", flush=True)
    else:
        raise AssertionError("a CP shape without kernels was not refused at build time")
    return counts


def probe_phase(device):
    """The probes P1a-P1g and P2 (``tools/microbench_gather.py``): each kernel
    at a reduced M (2^18 indices) against numpy and against its plain version
    on the CPU, and the edge cases of P1f / P1g (every index on one row), P1a
    unroll 8, P1b and P1e (a ragged count) and P2 (``check_p2_edges``); then
    the probe script's own run at the JAX scripts' sizes (its main path), the
    launch counters set to 0 just before it and read just after."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    errs = mb.check_all(PROBE_CHECK_M, PROBE_CHECK_M, device, seed=SEED)
    print(f"[probe] at M={PROBE_CHECK_M}: every probe equals numpy (gathers to the bit, sums "
          f"within 1e-6 of their summed magnitudes): {errs}", flush=True)
    edges = mb.check_edges(device, seed=SEED)
    print(f"[probe] P1f and P1g with every index on one row, P1a unroll 8 on 2,053 indices, "
          f"P1b on 25,577, P1e on 37 rows: equal to their plain versions (the gathers to the "
          f"bit, the scatters within 1e-6 of their summed magnitudes); P2 a / b / c on "
          f"{', '.join(mb.P2_EDGES)} (P2a / P2b equal to their emulated order, P2c to "
          f"numpy): {edges}", flush=True)
    for name, err in edges.items():
        errs[name] = max(errs[name], err)
    mb.reset_launches()
    entries = mb.run(1 << 22, mb.P2_M, device, seed=SEED,
                     log=lambda s: print(s, flush=True))
    counts = mb.launch_counts()
    for e in entries:
        e["launches"] = counts[e["name"]]
        e["launches_path"] = "probe_script"
        e["max_abs_err"] = max(e["max_abs_err"], errs[e["name"]])
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']}: not launched by the probe script")
    return entries


def launcher_phase(device, smi):
    """The repo's ``configs/nerf-synthetic.yaml``, unmodified, through the
    port's launcher: ``--train trainer.max_steps=LAUNCHER_STEPS`` (dynamic
    ray sampling from 256 rays, MultiStepLR, the automatic test and mesh
    after training), then ``--export`` of the last checkpoint with the
    launch counters read around it: test views with test/psnr in the CSV
    log, a non-empty mesh with valid indices, HG1 in the export's level
    grid and no backward launched."""
    import csv
    import glob

    from instant_nsr_pl_tpu_torch.launch import main as launch_main
    from instant_nsr_pl_tpu_torch.ops import hashgrid, sh_mlp
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj

    exp = os.path.join(ROOT, "exp", "chip_smoke_launcher")
    shutil.rmtree(os.path.join(exp, "nerf-synthetic"), ignore_errors=True)  # an earlier run's
    base = ["--config", REPO_NERF_CONFIG, "--exp_dir", exp, "tag=chip"]
    counters = {"hashgrid_forward": hashgrid.hashgrid_forward,
                "hashgrid_backward": hashgrid.hashgrid_backward,
                "sh_mlp_forward": sh_mlp.sh_mlp_forward, "sh_mlp_backward": sh_mlp.sh_mlp_backward}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc = launch_main(base + ["--train", f"trainer.max_steps={LAUNCHER_STEPS}",
                             f"trainer.val_check_interval={LAUNCHER_STEPS}"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {k: c.launches for k, c in counters.items()}
    assert rc == 0, rc
    (run,) = glob.glob(os.path.join(exp, "nerf-synthetic", "chip@*"))
    with open(os.path.join(run, "csv_logs", "metrics.csv")) as fh:
        rows = list(csv.DictReader(fh))
    test_psnr = [float(r["test/psnr"]) for r in rows if r.get("test/psnr")]
    rays = [float(r["train/num_rays"]) for r in rows if r.get("train/num_rays")]
    assert test_psnr and math.isfinite(test_psnr[-1]), "no test/psnr in the CSV log"
    n_test = len(glob.glob(os.path.join(run, "save", f"it{LAUNCHER_STEPS}-test", "*.png")))
    assert n_test == 8, n_test
    assert min(train_launches.values()) >= LAUNCHER_STEPS, train_launches
    ckpt = os.path.join(run, "ckpt", f"step={LAUNCHER_STEPS}.ckpt")
    obj = os.path.join(run, "save", f"it{LAUNCHER_STEPS}-nerf.obj")
    os.remove(obj)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc = launch_main(base + ["--export", "--resume", ckpt])
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    export_launches = {k: c.launches for k, c in counters.items()}
    assert rc == 0, rc
    mesh = load_obj(obj)
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v), "empty or broken mesh"
    assert export_launches["hashgrid_forward"] >= 8, export_launches  # 128^3 in chunks of 2^18
    assert export_launches["hashgrid_backward"] == export_launches["sh_mlp_backward"] == 0
    print(f"[launcher] configs/nerf-synthetic.yaml: {LAUNCHER_STEPS} steps + test in "
          f"{train_s:.1f} s (rays per step {rays[0]:.0f} -> {rays[-1]:.0f}), test/psnr "
          f"{test_psnr[-1]:.3f} dB over {n_test} views, launches {train_launches}; export "
          f"{export_s:.2f} s: {len(v)} vertices, {len(f)} faces, launches {export_launches} "
          f"({smi})", flush=True)
    return train_launches, export_launches


# ---------------------------------------------------------------------------
# slice 7: NeuS on the hash grid (HG3/HG4), ProgressiveBandHashGrid and its
# step-driven level mask, the repo's configs/neus-synthetic.yaml
# ---------------------------------------------------------------------------

REPO_NEUS_CONFIG = os.path.join(ROOT, "configs", "neus-synthetic.yaml")
NEUS_HASH_SIZES = (65536, N_FULL)  # the config's training and eval sample capacities
BAND_STEPS = 30
BAND_UPDATE_STEPS = 10  # neuralangelo-dtu-wmask.yaml's 1000, cut: the mask moves twice
# neuralangelo-dtu-wmask.yaml's geometry (:39-56) over configs/neus-synthetic.yaml:
# the encoding, the gradient type and the eps (its 512^3 isosurface is not
# what this run checks)
BAND_OVERRIDES = [
    "model.geometry.grad_type=finite_difference",
    "model.geometry.finite_difference_eps=progressive",
    "model.geometry.xyz_encoding_config.otype=ProgressiveBandHashGrid",
    "model.geometry.xyz_encoding_config.n_levels=16",
    "model.geometry.xyz_encoding_config.log2_hashmap_size=19",
    "model.geometry.xyz_encoding_config.start_level=4",
    "model.geometry.xyz_encoding_config.start_step=0",
    f"model.geometry.xyz_encoding_config.update_steps={BAND_UPDATE_STEPS}",
]


def neus_hash_spec():
    """configs/neus-synthetic.yaml's grid: 12 levels, F=2, 2^18 rows, base 32,
    scale 1.3195 (3 dense and 9 hashed levels, a 2,647,192-row table)."""
    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec

    return HashGridSpec(n_levels=12, n_features_per_level=2, log2_hashmap_size=18,
                        base_resolution=32, per_level_scale=1.3195079107728942)


def hash_grad_limits(tag, spec, got, ref):
    """The hash gradient limits (PERF.md section 2): the table gradient within
    1e-5 x max|ref| per level (float32 atomics sum in another order each
    run; ``ref`` may be the float64 sum of the same float32 updates), d x
    within 1e-4 x max|ref|. ``got`` and ``ref`` are (d table, d x or None).
    Returns the largest error."""
    (dt, dx), (rt, rx) = got, ref
    dt = dt.to(rt.dtype)
    for lv in range(spec.n_levels):
        sl = slice(spec.level_offsets[lv], spec.level_offsets[lv] + spec.level_sizes[lv])
        e = float((dt[sl] - rt[sl]).abs().max())
        t = 1e-5 * float(rt[sl].abs().max())
        if not e <= t:
            raise AssertionError(f"{tag} level {lv}: {e:.3e} > {t:.3e}")
    errs = [compare(f"{tag} d table", dt, rt, rel=1e-5)]
    if rx is not None:
        errs.append(compare(f"{tag} d x", dx, rx, rel=1e-4))
    return max(errs)


def hash_jac_kernel_phase(device):
    """HG3 (the hash encoding with its position Jacobian) and HG4 (its table
    gradient from both cotangents, and d x on request) at
    configs/neus-synthetic.yaml's grid, N=65,536 (a training step's
    capacity) and 262,144 (an eval chunk's), on uniform and on ray-ordered
    samples, without and with a ProgressiveBandHashGrid mask of 5 levels of
    12, against their plain versions on the same CUDA tensors: HG3's feat
    equal to HG1's to the bit, its jac within 2e-2 x max|plain|; HG4 within
    the hash gradient limits (``hash_grad_limits``, against the float64 sum of
    the plain version's updates); then timed beside their bounds, and HG4
    beside the same gradient from precomputed updates by ``index_add_``."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    spec = neus_hash_spec()
    gen = torch.Generator().manual_seed(SEED + 17)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(device)  # values of order 1
    n_max, lf = max(NEUS_HASH_SIZES), spec.n_output_dims
    x = torch.rand((n_max, 3), generator=gen)
    x[:6] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.75],
                          [0.0, 1.0, 0.5], [1.0, 0.0, 0.125], [0.999999, 1e-7, 0.5]])
    orders = {"uniform": x.to(device), "ray-ordered": positions(gen, "ray", n_max).to(device)}
    ct_f = torch.randn((n_max, lf), generator=gen).to(device)
    ct_j = torch.randn((3, n_max, lf), generator=gen).to(device)
    masks = {"": None, " band 5/12": (torch.arange(spec.n_levels) < 5).float().to(device)}
    errs = {"hashgrid_jac_forward": [], "hashgrid_jac_backward": []}
    for order, xs in orders.items():
        for n in NEUS_HASH_SIZES:
            xn, cf, cj = xs[:n], ct_f[:n], ct_j[:, :n].contiguous()
            for label, m in masks.items():
                tag = f"{order} N={n}{label}"
                feat, jac = hg.hashgrid_jac_forward_launch(table, xn, spec, m)
                hg1 = hg.hashgrid_forward_launch(table, xn, spec, m)
                torch.cuda.synchronize()
                if not torch.equal(feat, hg1):
                    raise AssertionError(f"hashgrid_jac_forward {tag}: feat differs from HG1's")
                _, rj = hg.hashgrid_jac_forward_plain(table, xn, spec, m)
                same = float((jac == rj).float().mean())
                errs["hashgrid_jac_forward"].append(
                    compare(f"hashgrid_jac_forward {tag} jac ({same:.4%} equal to the bit; "
                            "feat equal to HG1's)", jac, rj))
                got = hg.hashgrid_jac_backward_launch(table, xn, cf, cj, spec, m, with_dx=True)
                again = hg.hashgrid_jac_backward_launch(table, xn, cf, cj, spec, m, with_dx=True)
                dt_only, no_dx = hg.hashgrid_jac_backward_launch(table, xn, cf, cj, spec, m)
                torch.cuda.synchronize()
                assert no_dx is None
                if not torch.equal(got[1], again[1]):
                    raise AssertionError(f"hashgrid_jac_backward {tag}: d x differs between two "
                                         "calls")
                ref = hg.hashgrid_jac_backward_plain(table, xn, cf, cj, spec, m, with_dx=True,
                                                     accumulate=torch.float64)
                errs["hashgrid_jac_backward"] += [
                    hash_grad_limits(f"hashgrid_jac_backward {tag}", spec, got, ref),
                    hash_grad_limits(f"hashgrid_jac_backward {tag} without d x", spec,
                                     (dt_only, None), (ref[0], None))]
    # through the autograd op (the NeuS training path: the same HG3 and HG4)
    n, xn = NEUS_HASH_SIZES[0], orders["ray-ordered"][:NEUS_HASH_SIZES[0]]
    cf, cj = ct_f[:n], ct_j[:, :n].contiguous()
    t_req = table.clone().requires_grad_(True)
    feat, jac = hg.hashgrid_encode_with_jac(t_req, xn, spec)
    ((feat * cf).sum() + (jac * cj).sum()).backward()
    torch.cuda.synchronize()
    ref = hg.hashgrid_jac_backward_plain(table, xn, cf, cj, spec, accumulate=torch.float64)
    hash_grad_limits("hashgrid_encode_with_jac", spec, (t_req.grad, None), (ref[0], None))

    f, hashed = spec.n_features_per_level, sum(spec.level_hashed)
    table_bytes = spec.total_params * f * 4
    timings = {}
    for n in NEUS_HASH_SIZES:
        xn, cf, cj = orders["uniform"][:n], ct_f[:n], ct_j[:, :n].contiguous()
        # compulsory bytes: x, feat and jac (3 L F floats) per sample and the
        # table once; HG4 reads x and both cotangents, writes the gradient
        # once, and with d x reads the table and writes d x
        fwd_bound = bound(n * (12 + 4 * lf * 4) + table_bytes, 0,
                          n * spec.n_levels * 8 * (8 * f + 12))
        bwd_bound = bound(n * (12 + 4 * lf * 4) + table_bytes, 0,
                          n * spec.n_levels * 8 * (8 * f + 10))
        bwd_dx_bound = bound(n * (24 + 4 * lf * 4) + 2 * table_bytes, 0,
                             n * spec.n_levels * 8 * (16 * f + 30))
        sector_ms = bound(n * hashed * 8 * 32, 0, 0)[0]  # one 32-byte sector a hashed corner
        timings[n] = {
            "ms": time_ms(lambda: hg.hashgrid_jac_forward_launch(table, xn, spec)),
            "ms_masked": time_ms(lambda: hg.hashgrid_jac_forward_launch(table, xn, spec,
                                                                        masks[" band 5/12"])),
            "plain_ms": time_ms(lambda: hg.hashgrid_jac_forward_plain(table, xn, spec), reps=5,
                                inner=2),
            "device_ms": device_ms(lambda: hg.hashgrid_jac_forward_launch(table, xn, spec)),
            "hg1_ms": time_ms(lambda: hg.hashgrid_forward_launch(table, xn, spec)),
            "bwd_ms": time_ms(lambda: hg.hashgrid_jac_backward_launch(table, xn, cf, cj, spec)),
            "bwd_ms_dx": time_ms(lambda: hg.hashgrid_jac_backward_launch(table, xn, cf, cj, spec,
                                                                         with_dx=True)),
            "bwd_device_ms": device_ms(lambda: hg.hashgrid_jac_backward_launch(table, xn, cf, cj,
                                                                               spec)),
            "bwd_plain_ms": time_ms(lambda: hg.hashgrid_jac_backward_plain(table, xn, cf, cj,
                                                                           spec),
                                    reps=5, inner=2),
            "composed_ms": composed_hash_jac(device, spec, xn, cf, cj),
            "fwd_bound": fwd_bound, "bwd_bound": bwd_bound, "bwd_dx_bound": bwd_dx_bound[0],
            "sector_ms": sector_ms,
        }
        t = timings[n]
        print(f"[kernel] hashgrid_jac_forward at N={n}: {t['ms']:.4f} ms ({t['ms_masked']:.4f} "
              f"with the band mask; device {t['device_ms']:.4f}; HG1 alone {t['hg1_ms']:.4f}; "
              f"plain {t['plain_ms']:.3f}); "
              f"bound {fwd_bound[0]:.4f} ms by {fwd_bound[1]}, {sector_ms:.4f} ms by 32-byte "
              "sectors of the hashed levels' rows", flush=True)
        print(f"[kernel] hashgrid_jac_backward at N={n}: {t['bwd_ms']:.4f} ms, "
              f"{t['bwd_ms_dx']:.4f} with d x (device {t['bwd_device_ms']:.4f}; plain "
              f"{t['bwd_plain_ms']:.3f}; precomputed updates and one index_add_ per feature "
              f"{t['composed_ms']:.4f} ms); bound {bwd_bound[0]:.4f} ms by {bwd_bound[1]} "
              f"({bwd_dx_bound[0]:.4f} with d x), {sector_ms:.4f} ms by sectors", flush=True)
    n, big = NEUS_HASH_SIZES
    t, tb = timings[n], timings[big]
    note = ("no single PyTorch call hashes and interpolates with the Jacobian (or scatters its "
            "updates)")
    common = {"route": "cuda", "launches": 0, "library_ms": None, "library_note": note, "n": n,
              "bound_sectors_ms": t["sector_ms"], f"bound_sectors_ms_n{big}": tb["sector_ms"]}
    return [
        {**common, "name": "hashgrid_jac_forward",
         "source": "instant_nsr_pl_tpu_torch/csrc/hashgrid_jac_fwd.cu",
         "replaces": "instant_nsr_pl_tpu/ops/hashgrid.py:797 (_encode_jac_fwd_impl, XLA)",
         "max_abs_err": max(errs["hashgrid_jac_forward"]), "ms": t["ms"],
         "ms_masked": t["ms_masked"], "device_ms": t["device_ms"], "hg1_ms": t["hg1_ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["fwd_bound"][0], "bound_by": t["fwd_bound"][1],
         f"ms_n{big}": tb["ms"], f"device_ms_n{big}": tb["device_ms"],
         f"plain_ms_n{big}": tb["plain_ms"],
         f"bound_ms_n{big}": tb["fwd_bound"][0]},
        {**common, "name": "hashgrid_jac_backward",
         "source": "instant_nsr_pl_tpu_torch/csrc/hashgrid_jac_bwd.cu",
         "replaces": "instant_nsr_pl_tpu/ops/hashgrid.py:841 (_encode_jac_bwd, XLA)",
         "max_abs_err": max(errs["hashgrid_jac_backward"]), "ms": t["bwd_ms"],
         "ms_with_dx": t["bwd_ms_dx"], "device_ms": t["bwd_device_ms"],
         "composed_ms": t["composed_ms"], "plain_ms": t["bwd_plain_ms"],
         "bound_ms": t["bwd_bound"][0], "bound_by": t["bwd_bound"][1],
         "bound_ms_with_dx": t["bwd_dx_bound"], f"ms_n{big}": tb["bwd_ms"],
         f"device_ms_n{big}": tb["bwd_device_ms"], f"composed_ms_n{big}": tb["composed_ms"],
         f"plain_ms_n{big}": tb["bwd_plain_ms"], f"bound_ms_n{big}": tb["bwd_bound"][0]},
    ]


def _launcher_run(argv, rank_hook=None):
    """``instant_nsr_pl_tpu_torch.launch`` in this process (its ranks
    spawned from it under ``--devices``); returns the wall seconds (after
    the card's queue drains)."""
    from instant_nsr_pl_tpu_torch.launch import main as launch_main

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = launch_main(argv, rank_hook=rank_hook)
    torch.cuda.synchronize()
    assert rc == 0, rc
    return time.perf_counter() - t0


def _recording_steps(counters, last, warm_from, extra=None, label=""):
    """A stand-in for a system's ``train_step`` that records each step's
    launch counts, loss, inv_s (NeuS) and ray count (``records``) and the
    wall clock at the start of step ``warm_from`` and of step ``last``
    (``marks``), captures step ``last``'s kernels on their own operands
    (``capture_step_operands`` under ``label``), and calls ``extra(system,
    state, step)`` after each step."""
    from instant_nsr_pl_tpu_torch.systems.base import BaseSystem

    records, marks = [], {}

    def train_step(system, state):
        step = int(state["step"])
        if step in (warm_from, last):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()
        before = {k: c.launches for k, c in counters.items()}
        n_rays = system.active_num_rays
        if step == last:
            state, metrics = capture_step_operands(lambda: BaseSystem.train_step(system, state),
                                                   label, check=check_step_kernels)
        else:
            state, metrics = BaseSystem.train_step(system, state)
        records.append({"step": step, "rays": n_rays, "loss": metrics["train/loss"],
                        "inv_s": metrics.get("train/inv_s"),
                        "delta": {k: c.launches - before[k] for k, c in counters.items()}})
        if extra is not None:
            extra(system, state, step)
        return state, metrics

    return train_step, records, marks


def neus_hash_launcher_phase(device, smi):
    """The repo's ``configs/neus-synthetic.yaml``, unmodified (the hash grid
    with analytic gradients: HG3 / HG4 and K3 / K4 on every step; dynamic ray
    sampling; 65,536 training and 262,144 eval samples), through the port's
    launcher: ``--train trainer.max_steps=LAUNCHER_STEPS`` of its 2,000 (the
    automatic 8-view test and mesh), then ``--export`` of the checkpoint,
    timed by stage. Checks: HG3, HG4, K3 and K4 launched on every step (each
    step's counts recorded around it), the loss falling and inv_s rising, the
    val views at least 3 dB above the untrained model's (its parameters from
    the config's seed, the grid after one warmup update), test/psnr logged, a
    non-empty mesh with valid indices, HG1 in the export's level grid and HG3
    in its vertex colours, no backward. The last step's HG3 / HG4 launches
    are checked and timed on their own operands."""
    import csv
    import glob

    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.ops import hashgrid, sh_mlp
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays
    from instant_nsr_pl_tpu_torch.systems.neus import NeuSSystem
    from instant_nsr_pl_tpu_torch.tools.launch_timed import timed_export
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj

    # the untrained model: the launcher's parameters (the config's seed),
    # the grid after one warmup update
    cfg = load_config(REPO_NEUS_CONFIG)
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("fit")
    system = systems.make(cfg.system.name, cfg)
    system.setup_data(dm.train)
    state = system.init_state(seed=int(cfg.get("seed", 42)))
    geo = system.model.geometry
    assert geo.use_jac and geo.encoding.encoding.grad_mode == "fast" and system.model.texture.fused
    assert system.train_capacity == NEUS_HASH_SIZES[0] and system.dynamic_ray_sampling
    state["occ"] = system.model.update_occupancy(state["params"], state["occ"],
                                                 state["generator"], warmup=True)
    val = dataset_device_arrays(dm.val, device)
    untrained = [system.evaluate_image(state, i, data=val)["psnr"] for i in range(2)]
    del system, state, val
    torch.cuda.empty_cache()
    print(f"[neus-hash] untrained val views: PSNR {untrained[0]:.3f} / {untrained[1]:.3f} dB",
          flush=True)

    exp = os.path.join(ROOT, "exp", "chip_smoke_launcher")
    shutil.rmtree(os.path.join(exp, "neus-synthetic"), ignore_errors=True)  # an earlier run's
    base = ["--config", REPO_NEUS_CONFIG, "--exp_dir", exp, "tag=chip"]
    counters = {"hashgrid_jac_forward": hashgrid.hashgrid_jac_forward,
                "hashgrid_jac_backward": hashgrid.hashgrid_jac_backward,
                "hashgrid_forward": hashgrid.hashgrid_forward,
                "hashgrid_backward": hashgrid.hashgrid_backward,
                "sh_mlp_forward": sh_mlp.sh_mlp_forward, "sh_mlp_backward": sh_mlp.sh_mlp_backward}
    n_warm = min(100, LAUNCHER_STEPS // 3)
    train_step, records, marks = _recording_steps(counters, LAUNCHER_STEPS - 1,
                                                  LAUNCHER_STEPS - 1 - n_warm)
    for c in counters.values():
        c.launches = 0
    NeuSSystem.train_step = train_step
    try:
        train_s = _launcher_run(base + ["--train", f"trainer.max_steps={LAUNCHER_STEPS}",
                                        f"trainer.val_check_interval={LAUNCHER_STEPS}"])
    finally:
        del NeuSSystem.train_step  # the base class's again
    train_launches = {k: c.launches for k, c in counters.items()}
    assert len(records) == LAUNCHER_STEPS, len(records)
    for r in records:
        for k in ("hashgrid_jac_forward", "hashgrid_jac_backward", "sh_mlp_forward",
                  "sh_mlp_backward"):
            if r["delta"][k] < 1:
                raise AssertionError(f"neus-hash step {r['step']}: {k} was not launched: "
                                     f"{r['delta']}")
        if r["delta"]["hashgrid_backward"]:
            raise AssertionError(f"neus-hash step {r['step']}: HG2 ran: {r['delta']}")
    losses = [float(r["loss"]) for r in records]
    inv_s = [float(r["inv_s"]) for r in records]
    rays = [r["rays"] for r in records]
    warm_s = marks[LAUNCHER_STEPS - 1] - marks[LAUNCHER_STEPS - 1 - n_warm]
    rays_per_s = sum(rays[-1 - n_warm:-1]) / warm_s
    (run,) = glob.glob(os.path.join(exp, "neus-synthetic", "chip@*"))
    with open(os.path.join(run, "csv_logs", "metrics.csv")) as fh:
        rows = list(csv.DictReader(fh))
    test_psnr = [float(r["test/psnr"]) for r in rows if r.get("test/psnr")]
    val_psnr = [float(r["val/psnr"]) for r in rows if r.get("val/psnr")]
    n_test = len(glob.glob(os.path.join(run, "save", f"it{LAUNCHER_STEPS}-test", "*.png")))
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    print(f"[neus-hash] configs/neus-synthetic.yaml: {LAUNCHER_STEPS} steps + val + test in "
          f"{train_s:.1f} s; warm {rays_per_s:.0f} rays/s, {warm_s / n_warm * 1e3:.2f} ms per "
          f"step over steps {LAUNCHER_STEPS - 1 - n_warm}-{LAUNCHER_STEPS - 2} (rays per step "
          f"{rays[0]} -> {rays[-1]}); loss, first 20 steps {first:.5f}, last 20 {last:.5f}; "
          f"inv_s {inv_s[0]:.3f} -> {inv_s[-1]:.3f}; one step {records[1]['delta']}; launches "
          f"{train_launches} ({smi})", flush=True)
    print(f"[neus-hash] val PSNR after {LAUNCHER_STEPS} steps {val_psnr[-1]:.3f} dB (untrained "
          f"{np.mean(untrained):.3f}); test/psnr {test_psnr[-1]:.3f} dB over {n_test} views",
          flush=True)
    assert np.isfinite(losses).all() and last < first, "the loss did not fall"
    assert inv_s[-1] > inv_s[0], "inv_s did not rise"
    assert val_psnr[-1] >= np.mean(untrained) + 3.0, "training gained less than 3 dB"
    assert n_test == 8 and math.isfinite(test_psnr[-1]), (n_test, test_psnr)

    ckpt = os.path.join(run, "ckpt", f"step={LAUNCHER_STEPS}.ckpt")
    obj = os.path.join(run, "save", f"it{LAUNCHER_STEPS}-neus.obj")
    os.remove(obj)
    stage = {}
    for c in counters.values():
        c.launches = 0
    with timed_export(stage):
        export_s = _launcher_run(base + ["--export", "--resume", ckpt])
    export_launches = {k: c.launches for k, c in counters.items()}
    mesh = load_obj(obj)
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    rest = export_s - stage["level grid"] - stage["marching"] - stage["vertex colours"]
    print(f"[neus-hash] export {export_s:.2f} s: {len(v)} vertices, {len(f)} faces; level grid "
          f"{stage['level grid']:.3f} s, marching {stage['marching']:.3f} s (card), vertex "
          f"colours {stage['vertex colours']:.3f} s, the rest (loading, OBJ) {rest:.3f} s; "
          f"launches {export_launches} ({smi})", flush=True)
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v), "empty or broken mesh"
    assert export_launches["hashgrid_forward"] >= 8, export_launches  # 128^3 in chunks of 2^18
    assert export_launches["hashgrid_jac_forward"] >= 1, export_launches
    assert not any(export_launches[k] for k in counters if k.endswith("_backward"))
    return ({k: records[1]["delta"][k] for k in counters}, train_launches, export_launches,
            rays_per_s)


def band_launcher_phase(device, smi, config=None, overrides=BAND_OVERRIDES,
                        exp_name="chip_smoke_band", tag="band"):
    """configs/neus-synthetic.yaml with neuralangelo-dtu-wmask.yaml's geometry
    put over it on the command line (``BAND_OVERRIDES``: a
    ProgressiveBandHashGrid of 16 levels from level 4, update_steps cut to
    BAND_UPDATE_STEPS; finite differences with the progressive eps), or
    ``config`` with ``overrides``, through the launcher's ``--train`` for
    BAND_STEPS steps (the automatic test and mesh included): at every step
    each HG1 and HG2 launch carries the step's level mask, the stencil's eps
    is the progressive eps of the step's level, the mask moves at least
    twice, no HG3 / HG4 runs, and the loss stays finite. Returns the run's
    launch counts and its wall seconds."""
    from instant_nsr_pl_tpu_torch.models.geometry import VolumeSDF
    from instant_nsr_pl_tpu_torch.ops import hashgrid
    from instant_nsr_pl_tpu_torch.systems.neus import NeuSSystem

    exp = os.path.join(ROOT, "exp", exp_name)
    shutil.rmtree(exp, ignore_errors=True)  # an earlier run's
    masks, eps_seen = [], []
    fwd_fn, bwd_fn = hashgrid.hashgrid_forward_launch, hashgrid.hashgrid_backward_launch
    eps_fn = VolumeSDF.finite_difference_eps

    def record_fwd(table, x, spec, level_mask=None):
        masks.append(("hashgrid_forward", None if level_mask is None else level_mask.tolist()))
        return fwd_fn(table, x, spec, level_mask)

    def record_bwd(table, x, dout, spec, level_mask=None, with_dx=False):
        masks.append(("hashgrid_backward", None if level_mask is None else level_mask.tolist()))
        return bwd_fn(table, x, dout, spec, level_mask, with_dx)

    def eps(self, step=None):
        out = eps_fn(self, step)
        eps_seen.append((step, float(out)))
        return out

    per_step = {}

    def check(system, state, step):
        enc = system.model.geometry.encoding.encoding
        level = enc.current_level(step)
        want = [1.0] * level + [0.0] * (enc.spec.n_levels - level)
        seen = [m for _, m in masks]
        names = {n for n, _ in masks}
        if any(m != want for m in seen) or names != {"hashgrid_forward", "hashgrid_backward"}:
            raise AssertionError(f"{tag} step {step}: HG1 / HG2 launched with masks "
                                 f"{sorted(set(map(str, seen)))} (names {names}), want {want}")
        spec = enc.spec
        res = np.float32(spec.base_resolution) * np.float32(spec.per_level_scale) ** np.float32(
            level - 1)
        expect = float(np.float32(2.0 * system.model.radius) / np.float32(res))
        # the eps of the step's level (float32 powers may differ in the last place)
        if not eps_seen or any(abs(e - expect) > 1e-6 * expect for _, e in eps_seen):
            raise AssertionError(f"{tag} step {step}: eps {eps_seen} != {expect} (level {level})")
        per_step[step] = (level, eps_seen[-1][1], len(seen))
        masks.clear()
        eps_seen.clear()

    counters = {"hashgrid_forward": hashgrid.hashgrid_forward,
                "hashgrid_backward": hashgrid.hashgrid_backward,
                "hashgrid_jac_forward": hashgrid.hashgrid_jac_forward,
                "hashgrid_jac_backward": hashgrid.hashgrid_jac_backward}
    train_step, records, _ = _recording_steps(counters, -1, -1, extra=check)
    for c in counters.values():
        c.launches = 0
    hashgrid.hashgrid_forward_launch, hashgrid.hashgrid_backward_launch = record_fwd, record_bwd
    VolumeSDF.finite_difference_eps = eps
    NeuSSystem.train_step = train_step
    try:
        wall = _launcher_run(["--config", config or REPO_NEUS_CONFIG, "--exp_dir", exp,
                              "tag=chip", "--train", f"trainer.max_steps={BAND_STEPS}",
                              f"trainer.val_check_interval={BAND_STEPS}", *overrides])
    finally:
        del NeuSSystem.train_step
        VolumeSDF.finite_difference_eps = eps_fn
        hashgrid.hashgrid_forward_launch, hashgrid.hashgrid_backward_launch = fwd_fn, bwd_fn
    launches = {k: c.launches for k, c in counters.items()}
    losses = [float(r["loss"]) for r in records]
    levels = [per_step[s][0] for s in sorted(per_step)]
    print(f"[{tag}] {BAND_STEPS} steps + val + test + mesh in {wall:.1f} s; level by step "
          f"{levels}; eps {sorted({(v[0], v[1]) for v in per_step.values()})}; HG1 + HG2 "
          f"launches a step {per_step[1][2]}; loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"launches {launches} ({smi})", flush=True)
    assert len(per_step) == BAND_STEPS and len(set(levels)) >= 3, levels
    assert np.isfinite(losses).all(), "the loss went non-finite"
    assert launches["hashgrid_jac_forward"] == launches["hashgrid_jac_backward"] == 0, launches
    assert min(launches["hashgrid_forward"], launches["hashgrid_backward"]) >= BAND_STEPS
    return launches, wall


# ---------------------------------------------------------------------------
# slice 8: the Blender and DTU loaders on data80 and on a DTU-layout export
# of the port's own, through configs/{nerf,neus}-blender.yaml,
# neus-dtu-wmask.yaml and neuralangelo-dtu-wmask.yaml
# ---------------------------------------------------------------------------

DATA80 = os.path.join(ROOT, "data80", "blender")
DTU_EXPORT = os.path.join(ROOT, "exp", "chip_smoke_data")
DTU_VIEWS = 49  # DTU's view count; 800x800 (DTU's 1600x1200, cut so the export stays quick)
DTU_SIZE = 800
DTU_TEST_VIEWS = 10  # the configs' n_test_traj_steps 60, cut
# the configs' isosurfaces (NeRF 256^3, NeuS 512^3), cut: marching and the
# OBJ run on the host (measured uncut with tools/launch_timed.py)
ISO_CUT = 128
BLENDER_DATA = ["dataset.scene=procsphere", f"dataset.root_dir={DATA80}",
                f"model.geometry.isosurface.resolution={ISO_CUT}"]
# the paths: config, overrides, the split whose PSNR the run is held to
# (DTU's test frames are blank: its val split, the training images), the
# views of that split, and the kernels every step launches
DATASET_PATHS = {
    "blender_nerf": ("nerf-blender.yaml", BLENDER_DATA, "test", 4,
                     ("hashgrid_forward", "hashgrid_backward", "sh_mlp_forward",
                      "sh_mlp_backward")),
    "blender_neus": ("neus-blender.yaml", BLENDER_DATA, "test", 4,
                     ("hashgrid_jac_forward", "hashgrid_jac_backward", "sh_mlp_forward",
                      "sh_mlp_backward")),
    "dtu_neus": ("neus-dtu-wmask.yaml",
                 [f"dataset.root_dir={os.path.join(DTU_EXPORT, 'dtu')}",
                  f"dataset.n_test_traj_steps={DTU_TEST_VIEWS}",
                  f"model.geometry.isosurface.resolution={ISO_CUT}"], "val", 2,
                 # the DTU configs' radiance head is a float32 VanillaMLP:
                 # not K3 / K4's bf16 head, in the JAX package as here
                 ("hashgrid_jac_forward", "hashgrid_jac_backward")),
}
# slice 9: the unbounded-scene configs on a COLMAP export of the scene and on
# the DTU export (neus-dtu.yaml: DTU without masks, with the background)
COLMAP_EXPORT = os.path.join(ROOT, "exp", "chip_smoke_colmap")
COLMAP_VIEWS = 80  # data80's train split: 80 views at 800x800
COLMAP_SIZE = 800
# the background is a textured sphere at 4x the cameras' distance (the
# export's --backdrop), not white: an unbounded capture's surroundings, which
# the learned background takes on and a foreground shell cannot
COLMAP_BACKDROP = 10.0
# the procedural scene has no ground plane: the RANSAC of the configs'
# up_est_method "ground" finds an arbitrary plane through sphere points
COLMAP_OVERRIDES = [f"dataset.root_dir={os.path.join(COLMAP_EXPORT, 'colmap')}",
                    "dataset.up_est_method=camera",
                    f"dataset.n_test_traj_steps={DTU_TEST_VIEWS}",
                    f"model.geometry.isosurface.resolution={ISO_CUT}"]
BG_KERNELS = ("hashgrid_jac_forward", "hashgrid_jac_backward", "hashgrid_forward",
              "hashgrid_backward")
DATASET_PATHS.update({
    "colmap_nerf": ("nerf-colmap.yaml", COLMAP_OVERRIDES, "val", 2,
                    ("hashgrid_forward", "hashgrid_backward", "sh_mlp_forward",
                     "sh_mlp_backward")),
    # the NeuS configs' heads (and texture_bg) are float32 VanillaMLPs: no K3 / K4
    "colmap_neus": ("neus-colmap.yaml", COLMAP_OVERRIDES, "val", 2, BG_KERNELS),
    "dtu_bg_neus": ("neus-dtu.yaml",
                    [f"dataset.root_dir={os.path.join(DTU_EXPORT, 'dtu')}",
                     f"dataset.n_test_traj_steps={DTU_TEST_VIEWS}",
                     f"model.geometry.isosurface.resolution={ISO_CUT}"], "val", 2, BG_KERNELS),
})
DTU_BAND_OVERRIDES = [f"dataset.root_dir={os.path.join(DTU_EXPORT, 'dtu')}",
                      f"dataset.n_test_traj_steps={DTU_TEST_VIEWS}",
                      f"model.geometry.isosurface.resolution={ISO_CUT}",
                      f"model.geometry.xyz_encoding_config.update_steps={BAND_UPDATE_STEPS}"]


def dtu_export_phase():
    """The procedural scene's DTU layout (``tools/make_synthetic_data.py``):
    DTU_VIEWS views at DTU_SIZE x DTU_SIZE into ``exp/chip_smoke_data/dtu``.
    Returns the wall seconds."""
    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data

    shutil.rmtree(DTU_EXPORT, ignore_errors=True)
    t0 = time.perf_counter()
    assert make_synthetic_data.main(["--out", DTU_EXPORT, "--format", "dtu", "--size",
                                     str(DTU_SIZE), "--n-train", str(DTU_VIEWS)]) == 0
    wall = time.perf_counter() - t0
    print(f"[dtu-export] {DTU_VIEWS} views at {DTU_SIZE}x{DTU_SIZE} (RGB + L mask PNGs, "
          f"cameras_sphere.npz) in {wall:.2f} s (host)", flush=True)
    return wall


def colmap_export_phase():
    """The procedural scene's COLMAP layout (``tools/make_synthetic_data.py``):
    COLMAP_VIEWS views at COLMAP_SIZE x COLMAP_SIZE into
    ``exp/chip_smoke_colmap/colmap``. Returns the wall seconds."""
    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data

    shutil.rmtree(COLMAP_EXPORT, ignore_errors=True)
    t0 = time.perf_counter()
    assert make_synthetic_data.main(["--out", COLMAP_EXPORT, "--format", "colmap", "--size",
                                     str(COLMAP_SIZE), "--n-train", str(COLMAP_VIEWS),
                                     "--backdrop", str(COLMAP_BACKDROP)]) == 0
    wall = time.perf_counter() - t0
    print(f"[colmap-export] {COLMAP_VIEWS} views at {COLMAP_SIZE}x{COLMAP_SIZE} (RGB PNGs on a "
          f"textured backdrop of radius {COLMAP_BACKDROP}, sparse/0 cameras, images, points3D) "
          f"in {wall:.2f} s (host)", flush=True)
    return wall


def _grid_and_sample_recorders(system_cls, model_cls, warmups, shares):
    """Wrap ``system_cls.update_occupancy`` and ``model_cls.forward``: each
    warmup update's wall seconds, the card's peak allocation during it and
    the allocation before it go to ``warmups``; each training forward's
    packed live counts and capacities (foreground, and the background's where
    the model has one) to ``shares``. Returns a function that undoes both."""
    update, forward = system_cls.update_occupancy, model_cls.forward

    def update_occupancy(self, state, warmup):
        if not warmup:
            return update(self, state, warmup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state = update(self, state, warmup)
        torch.cuda.synchronize()
        warmups.append({"s": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
                        "before": before,
                        "cells": sum(g.occs.numel() for g in state["occ"].values())})
        return state

    def recording_forward(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        if kwargs.get("train"):
            shares.append((out["num_samples"], kwargs["capacity"], out.get("num_samples_bg"),
                           kwargs.get("capacity_bg")))
        return out

    system_cls.update_occupancy = update_occupancy
    model_cls.forward = recording_forward

    def undo():
        del system_cls.update_occupancy  # the base class's again
        model_cls.forward = forward
    return undo


def _sdf_over_box(run, config, overrides, device):
    """The trained NeuS foreground SDF of the run's last checkpoint at 64^3
    points over its AABB: min, max and the share below 0; and on the first
    val view the share of pixels whose foreground opacity exceeds 0.5 (a
    foreground that covers the whole view is a shell, not the object)."""
    import glob

    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays
    from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint

    (ckpt,) = glob.glob(os.path.join(run, "ckpt", "*.ckpt"))
    cfg = load_config(config, cli_args=overrides)
    system = systems.make(cfg.system.name, cfg)
    state = load_checkpoint(ckpt, system.init_state(0))
    c = torch.linspace(-system.model.radius, system.model.radius, 64, device=device)
    pts = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    with torch.no_grad():
        sdf = system.model.forward_level(state["params"], pts, step=state["step"])
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("validate")
    system.setup_data(dm.val)
    opacity = system.render_image(state, 0, data=dataset_device_arrays(dm.val, device))["opacity"]
    out = {"min": float(sdf.min()), "max": float(sdf.max()),
           "negative_share": float((sdf < 0).float().mean()),
           "fg_opaque_pixel_share": float((opacity > 0.5).mean())}
    del system, state, dm
    torch.cuda.empty_cache()
    return out


def _untrained_psnr(config, overrides, split, n_views, device):
    """The mean PSNR over ``n_views`` views of ``split`` of the model the
    launcher starts from: its parameters from the config's seed, the grid
    after one warmup update."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays

    cfg = load_config(config, cli_args=overrides)
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("test" if split == "test" else "validate")
    ds = dm.test if split == "test" else dm.val
    system = systems.make(cfg.system.name, cfg)
    system.setup_data(ds)
    state = system.init_state(seed=int(cfg.get("seed", 42)))
    state["occ"] = system.model.update_occupancy(state["params"], state["occ"],
                                                 state["generator"], warmup=True, step=0)
    data = dataset_device_arrays(ds, device)
    psnrs = [system.evaluate_image(state, i, data=data)["psnr"] for i in range(n_views)]
    del system, state, data, dm
    torch.cuda.empty_cache()
    return float(np.mean(psnrs))


def dataset_launcher_phase(device, smi, key):
    """One of ``DATASET_PATHS`` through the port's launcher: ``--train
    trainer.max_steps=LAUNCHER_STEPS`` of the config's 20,000 (the automatic
    test and mesh after it), the splits' load seconds (decode, resize) and
    the export's seconds by stage recorded. Checks: the path's kernels
    launched on every step (each step's counts recorded around it), the last
    step's HG1-HG4 / K3 / K4 launches held against their plain versions on
    their own operands (``check_step_kernels``), the loss finite and falling,
    the held split's PSNR at least 3 dB above the untrained model's, a
    non-empty mesh with valid indices; for DTU a finite chamfer against the
    scene's analytic surface (``tools/eval_chamfer.py``); for the NeRF a
    ``--export`` of the checkpoint with HG1 in its level grid and no
    backward. Returns a dict of the run's figures."""
    import csv
    import glob

    from instant_nsr_pl_tpu_torch.datasets.colmap import ColmapDatasetBase
    from instant_nsr_pl_tpu_torch.models.nerf import NeRFModel
    from instant_nsr_pl_tpu_torch.models.neus import NeuSModel
    from instant_nsr_pl_tpu_torch.ops import hashgrid, sh_mlp
    from instant_nsr_pl_tpu_torch.systems.nerf import NeRFSystem
    from instant_nsr_pl_tpu_torch.systems.neus import NeuSSystem
    from instant_nsr_pl_tpu_torch.tools.eval_chamfer import mesh_chamfer
    from instant_nsr_pl_tpu_torch.tools.launch_timed import timed_export, timed_loads
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj

    name, overrides, held, n_views, required = DATASET_PATHS[key]
    config = os.path.join(ROOT, "configs", name)
    nerf = key.endswith("nerf")
    untrained = _untrained_psnr(config, overrides, held, n_views, device)
    print(f"[{key}] untrained {held} PSNR over {n_views} views: {untrained:.3f} dB", flush=True)

    # the untrained model's load filled the COLMAP parse cache: empty it, so
    # the launcher's loads are timed
    ColmapDatasetBase._cache.clear()
    exp = os.path.join(ROOT, "exp", "chip_smoke_datasets", key)
    shutil.rmtree(exp, ignore_errors=True)  # an earlier run's
    base = ["--config", config, "--exp_dir", exp, "tag=chip", *overrides]
    counters = {"hashgrid_forward": hashgrid.hashgrid_forward,
                "hashgrid_backward": hashgrid.hashgrid_backward,
                "hashgrid_jac_forward": hashgrid.hashgrid_jac_forward,
                "hashgrid_jac_backward": hashgrid.hashgrid_jac_backward,
                "sh_mlp_forward": sh_mlp.sh_mlp_forward, "sh_mlp_backward": sh_mlp.sh_mlp_backward}
    n_warm = min(100, LAUNCHER_STEPS // 3)
    train_step, records, marks = _recording_steps(counters, LAUNCHER_STEPS - 1,
                                                  LAUNCHER_STEPS - 1 - n_warm, label=f"@{key}")
    loads, stage, warmups, shares = [], {}, [], []
    system_cls = NeRFSystem if nerf else NeuSSystem
    for c in counters.values():
        c.launches = 0
    system_cls.train_step = train_step
    undo = _grid_and_sample_recorders(system_cls, NeRFModel if nerf else NeuSModel, warmups,
                                      shares)
    try:
        with timed_loads(loads), timed_export(stage):
            train_s = _launcher_run(base + ["--train", f"trainer.max_steps={LAUNCHER_STEPS}",
                                            f"trainer.val_check_interval={LAUNCHER_STEPS}"])
    finally:
        del system_cls.train_step  # the base class's again
        undo()
    train_launches = {k: c.launches for k, c in counters.items()}
    assert len(records) == LAUNCHER_STEPS, len(records)
    for r in records:
        for k in required:
            if r["delta"][k] < 1:
                raise AssertionError(f"{key} step {r['step']}: {k} was not launched: "
                                     f"{r['delta']}")
    assert min(train_launches[k] for k in required) >= LAUNCHER_STEPS, train_launches
    losses = [float(r["loss"]) for r in records]
    rays = [r["rays"] for r in records]
    warm_s = marks[LAUNCHER_STEPS - 1] - marks[LAUNCHER_STEPS - 1 - n_warm]
    rays_per_s = sum(rays[-1 - n_warm:-1]) / warm_s
    (run,) = glob.glob(os.path.join(exp, "*", "chip@*"))
    with open(os.path.join(run, "csv_logs", "metrics.csv")) as fh:
        rows = list(csv.DictReader(fh))
    test_psnr = [float(r["test/psnr"]) for r in rows if r.get("test/psnr")]
    val_psnr = [float(r["val/psnr"]) for r in rows if r.get("val/psnr")]
    trained = test_psnr[-1] if held == "test" else val_psnr[-1]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    obj = os.path.join(run, "save", f"it{LAUNCHER_STEPS}-{'nerf' if nerf else 'neus'}.obj")
    mesh = load_obj(obj)
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    assert len(shares) == LAUNCHER_STEPS and warmups, (len(shares), len(warmups))
    fg_live = [min(int(n), cap) / cap for n, cap, _, _ in shares[-1 - n_warm:-1]]
    bg_live = [min(int(n), cap) / cap for _, _, n, cap in shares[-1 - n_warm:-1]
               if n is not None]
    out = {"untrained": untrained, "trained": trained, "test_psnr": test_psnr[-1],
           "train_s": train_s, "rays_per_s": rays_per_s, "loads": loads,
           "stages": dict(stage), "vertices": len(v), "faces": len(f),
           "launches": train_launches, "step": records[1]["delta"],
           "ms_per_step": warm_s / n_warm * 1e3, "fg_live_share": float(np.mean(fg_live)),
           "run": run, "base_args": base,
           "bg_live_share": float(np.mean(bg_live)) if bg_live else None,
           "grid_warmups": warmups}
    load_line = "; ".join(f"{d['split']} {d['views']} views at {d['wh'][0]}x{d['wh'][1]} "
                          f"{d['wall']:.2f} s (decode {d['decode']:.2f}, resize "
                          f"{d['resize']:.2f})" for d in loads)
    print(f"[{key}] configs/{name}: loads {load_line} (host)", flush=True)
    print(f"[{key}] {LAUNCHER_STEPS} steps + val + test + mesh in {train_s:.1f} s; warm "
          f"{rays_per_s:.0f} rays/s, {warm_s / n_warm * 1e3:.2f} ms per step (rays per step "
          f"{rays[0]} -> {rays[-1]}); loss, first 20 steps {first:.5f}, last 20 {last:.5f}; "
          f"{held} PSNR {trained:.3f} dB (untrained {untrained:.3f}), test/psnr "
          f"{test_psnr[-1]:.3f}; one step {records[1]['delta']}; launches {train_launches} "
          f"({smi})", flush=True)
    rest = stage["export"] - stage["level grid"] - stage["marching"] - stage["vertex colours"]
    w_s = [w["s"] for w in warmups]
    print(f"[{key}] packed samples live over the warm steps: foreground "
          f"{out['fg_live_share']:.4f} of {shares[-1][1]}"
          + (f", background {out['bg_live_share']:.4f} of {shares[-1][3]}" if bg_live else "")
          + f"; {len(warmups)} grid warmup updates ({warmups[0]['cells']} cells each) "
          f"{min(w_s):.3f}-{max(w_s):.3f} s, peak allocated "
          f"{max(w['peak'] for w in warmups) / 2**30:.2f} GiB "
          f"({warmups[0]['before'] / 2**30:.2f} GiB before the first) ({smi})", flush=True)
    print(f"[{key}] mesh export {stage['export']:.2f} s: {len(v)} vertices, {len(f)} faces; "
          f"level grid {stage['level grid']:.3f} s, marching {stage['marching']:.3f} s (card), "
          f"vertex colours {stage['vertex colours']:.3f} s, the rest (OBJ) {rest:.3f} s "
          f"({smi})", flush=True)
    if not nerf:
        out["sdf"] = _sdf_over_box(run, config, overrides, device)
        print(f"[{key}] foreground SDF over the AABB (64^3 points): {json.dumps(out['sdf'])} "
              f"({smi})", flush=True)
    assert np.isfinite(losses).all() and last < first, "the loss did not fall"
    assert trained >= untrained + 3.0, f"{key}: training gained less than 3 dB"
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v), "empty or broken mesh"
    if key.startswith("dtu"):
        t0 = time.perf_counter()
        out["chamfer"] = mesh_chamfer(mesh)
        print(f"[{key}] chamfer against the analytic surface: {json.dumps(out['chamfer'])} "
              f"({time.perf_counter() - t0:.2f} s, host)", flush=True)
        assert math.isfinite(out["chamfer"]["chamfer"]), out["chamfer"]
    if nerf:
        ckpt = os.path.join(run, "ckpt", f"step={LAUNCHER_STEPS}.ckpt")
        os.remove(obj)
        for c in counters.values():
            c.launches = 0
        out["export_s"] = _launcher_run(base + ["--export", "--resume", ckpt])
        out["export_launches"] = {k: c.launches for k, c in counters.items()}
        mesh = load_obj(obj)
        v, f = mesh["v_pos"], mesh["t_pos_idx"]
        print(f"[{key}] --export {out['export_s']:.2f} s: {len(v)} vertices, {len(f)} faces; "
              f"launches {out['export_launches']} ({smi})", flush=True)
        assert len(f) > 0 and f.min() >= 0 and f.max() < len(v), "empty or broken mesh"
        assert out["export_launches"]["hashgrid_forward"] >= 1, out["export_launches"]
        assert not any(out["export_launches"][k] for k in counters if k.endswith("_backward"))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 14: JPEG captures through the COLMAP loader, and the per-ray
# compositing sum's custom VJP on a training step's operands
# ---------------------------------------------------------------------------

JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
JPEG_DIGESTS = os.path.join(JPEG_FIXTURES, "digests.json")
JPEG_CAPTURE = os.path.join(JPEG_FIXTURES, "colmap")  # 24 views, JPEG q90 4:2:0, JPEG masks
# the loader settings of the digests (tests/test_torch_port_jpeg.py LOADER_CONFIG);
# nerf-colmap.yaml's model unmodified, its mesh cut as the other COLMAP runs':
# at the config's 256^3 the mesh has ~20 M faces, and reading its OBJ back
# twice took ~250 s of the script's 1,200
JPEG_OVERRIDES = [f"dataset.root_dir={JPEG_CAPTURE}", "dataset.img_downscale=2",
                  "dataset.up_est_method=camera", f"dataset.n_test_traj_steps={DTU_TEST_VIEWS}",
                  f"model.geometry.isosurface.resolution={ISO_CUT}"]
DATASET_PATHS["jpeg_colmap_nerf"] = ("nerf-colmap.yaml", JPEG_OVERRIDES, "val", 2,
                                     ("hashgrid_forward", "hashgrid_backward", "sh_mlp_forward",
                                      "sh_mlp_backward"))


def _sha256(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def jpeg_decode_check(smi):
    """Every committed JPEG fixture through ``read_jpeg`` (``utils/
    jpeg_decode.cc``, g++ on this host) against the digest of PIL's array
    (sha256, shape, mode; ``tests/fixtures/jpeg/digests.json``, written with
    PIL 12.1.0 / libjpeg-turbo 3.1.3). Then the decode rate in megapixels
    per second: the largest fixture (median of 10 decodes), and the
    capture's 24 images serially and on the loader's threads (median of 5
    passes). Returns the figures."""
    from concurrent.futures import ThreadPoolExecutor

    from instant_nsr_pl_tpu_torch.datasets.colmap import DECODE_THREADS
    from instant_nsr_pl_tpu_torch.utils.image_io import read_jpeg

    with open(JPEG_DIGESTS) as fh:
        want = json.load(fh)["pil"]
    bad = []
    for rel in sorted(want):
        a, mode = read_jpeg(os.path.join(JPEG_FIXTURES, rel))
        if {"sha256": _sha256(a), "shape": list(a.shape), "mode": mode} != want[rel]:
            bad.append(rel)
    assert not bad, f"JPEG decodes that differ from PIL's: {bad}"

    def rate(paths, reps, threads=1):
        mp = sum(math.prod(want[p]["shape"][:2]) for p in paths) / 1e6
        full = [os.path.join(JPEG_FIXTURES, p) for p in paths]
        walls = []
        with ThreadPoolExecutor(threads) as pool:
            for _ in range(reps):
                t0 = time.perf_counter()
                list(pool.map(read_jpeg, full))
                walls.append(time.perf_counter() - t0)
        return mp / statistics.median(walls)

    large = max(want, key=lambda p: math.prod(want[p]["shape"][:2]))
    capture = [p for p in sorted(want) if p.startswith("colmap/images/")]
    out = {"fixtures": len(want), "largest": large, "largest_mp_per_s": rate([large], 10),
           "capture_views": len(capture), "capture_mp_per_s": rate(capture, 5),
           "capture_mp_per_s_threads": rate(capture, 5, DECODE_THREADS),
           "threads": DECODE_THREADS}
    print(f"[jpeg] {len(want)} fixtures decoded equal to PIL's digests (sha256, shape, mode); "
          f"decode rate: {large} {out['largest_mp_per_s']:.1f} MP/s (median of 10), the "
          f"capture's {len(capture)} images {out['capture_mp_per_s']:.1f} MP/s serially, "
          f"{out['capture_mp_per_s_threads']:.1f} MP/s on {DECODE_THREADS} threads (host) "
          f"({smi})", flush=True)
    return out


def jpeg_loader_check(smi):
    """The JPEG capture through ``datasets.make("colmap", ...)`` at the
    digests' settings: the train split's images, masks and directions
    against the digests of the JAX loader's arrays; the load seconds."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.datasets.colmap import DECODE_THREADS, ColmapDatasetBase
    from instant_nsr_pl_tpu_torch.registry import datasets

    with open(JPEG_DIGESTS) as fh:
        want = json.load(fh)["loader"]
    cfg = dict(want["config"], root_dir=os.path.join(JPEG_FIXTURES, want["config"]["root_dir"]))
    ColmapDatasetBase._cache.clear()
    t0 = time.perf_counter()
    dm = datasets.make("colmap", config_from_dict(cfg))
    dm.setup("fit")
    wall = time.perf_counter() - t0
    ColmapDatasetBase._cache.clear()
    ds = dm.train
    for key, a in (("images", ds.all_images), ("masks", ds.all_fg_masks),
                   ("directions", ds.directions)):
        got = {"sha256": _sha256(np.asarray(a, np.float32)), "shape": list(np.shape(a))}
        assert got == want[key], f"the JPEG capture's {key} differ from the JAX loader's: {got}"
    out = {"wall": wall, **ds.load_seconds, "views": len(ds.all_images), "wh": list(ds.img_wh)}
    print(f"[jpeg] COLMAP loader on the JPEG capture: images, masks and directions equal to the "
          f"JAX loader's digests; {out['views']} views at {out['wh'][0]}x{out['wh'][1]} (and "
          f"their JPEG masks) loaded in {wall:.3f} s: decode {out['decode']:.3f} s (batches on "
          f"{DECODE_THREADS} threads), resize {out['resize']:.3f} s (host) ({smi})", flush=True)
    return out


def compositing_vjp_check(operands, smi):
    """The per-ray compositing sum's custom VJP (``ops/rendering.py``
    ``segment_sum_sorted``, one gather) against autograd through the same
    float64 prefix-sum forward (``segment_sum_prefix``, the backward the
    port had before) on a training step's captured operands (weights,
    values, ray ends, valid mask, block size) and a seeded cotangent: the
    forward to the bit, d weights and d values within 1e-6 x max|grad|;
    then each segment-sum backward alone (the per-ray cotangent to the rows'
    gradient) timed with CUDA events, back to back (the host's autograd
    share included) and one call at a time queued behind a spin kernel
    (device time: ``tools/microbench_gather.py`` ``time_ms``)."""
    from instant_nsr_pl_tpu_torch.ops import rendering
    from instant_nsr_pl_tpu_torch.tools.microbench_gather import time_ms as queued_ms

    w0, v0, ends, valid, group = operands
    gen = torch.Generator(device=w0.device).manual_seed(SEED)
    ct = torch.randn((ends.shape[0], v0.shape[1]), generator=gen, device=w0.device)
    fig = {"rows": w0.shape[0] // group, "rays": ends.shape[0], "d": v0.shape[1],
           "group": group}
    got = {}
    for name, fn in (("vjp", rendering.segment_sum_sorted),
                     ("autograd", rendering.segment_sum_prefix)):
        w, v = w0.clone().requires_grad_(), v0.clone().requires_grad_()
        src = torch.where(valid, w, torch.zeros_like(w))[:, None] * v
        if group > 1:
            src = src.reshape(-1, group, src.shape[1]).sum(dim=1)
        out = fn(src, ends // group)
        got[name] = (out.detach(), *torch.autograd.grad(out, (w, v), ct))
        leaf = src.detach().requires_grad_()
        seg = fn(leaf, ends // group)

        def backward(seg=seg, leaf=leaf):
            return torch.autograd.grad(seg, leaf, ct, retain_graph=True)

        fig[f"{name}_ms"] = time_ms(backward)
        fig[f"{name}_device_ms"] = queued_ms(backward, inner=1)
    assert torch.equal(got["vjp"][0], got["autograd"][0]), "the forward changed"
    for i, key in ((1, "d_weights"), (2, "d_values")):
        ref = float(got["autograd"][i].abs().max())
        fig[f"{key}_max_abs_diff"] = float((got["vjp"][i] - got["autograd"][i]).abs().max())
        fig[f"{key}_max_abs"] = ref
        assert fig[f"{key}_max_abs_diff"] <= 1e-6 * ref, (key, fig)
    print(f"[compositing-vjp] a training step's operands ({fig['rows']} rows after blocks of "
          f"{group}, {fig['rays']} rays, D = {fig['d']}): forward equal to the bit; largest "
          f"difference d weights {fig['d_weights_max_abs_diff']:.3e} (max |grad| "
          f"{fig['d_weights_max_abs']:.3e}), d values {fig['d_values_max_abs_diff']:.3e} (max "
          f"{fig['d_values_max_abs']:.3e}); segment-sum backward: VJP {fig['vjp_ms']:.4f} ms "
          f"(device {fig['vjp_device_ms']:.4f}), autograd {fig['autograd_ms']:.4f} ms (device "
          f"{fig['autograd_device_ms']:.4f}) ({smi})", flush=True)
    return fig


def jpeg_phase(device, smi):
    """Slice 14: the fixtures' decodes (``jpeg_decode_check``), the loader
    on the JPEG capture (``jpeg_loader_check``), then
    ``configs/nerf-colmap.yaml`` trained through the launcher on that
    capture (``dataset_launcher_phase``: the loss falling, val 3 dB above
    the untrained model, a non-empty mesh), its last training step's
    compositing operands captured for ``compositing_vjp_check`` and its
    weights' operands for ``segmented_cumsum_check``. Returns the
    figures."""
    from instant_nsr_pl_tpu_torch.models import nerf as nerf_model

    fig = {"decode": jpeg_decode_check(smi), "loader": jpeg_loader_check(smi)}
    captured = []
    accumulate = nerf_model.accumulate_along_rays

    def capturing(weights, values, ends, valid=None, group=1):
        if torch.is_grad_enabled() and weights.requires_grad:
            captured[:] = [(weights.detach().clone(), values.detach().clone(), ends.clone(),
                            valid.clone(), group)]
        return accumulate(weights, values, ends, valid=valid, group=group)

    weights_of = nerf_model.render_weight_from_density
    weights_captured = []

    def capturing_weights(t_starts, t_ends, sigma, ray_indices, valid, group=1):
        if torch.is_grad_enabled() and sigma.requires_grad:
            weights_captured[:] = [(t_starts.detach().clone(), t_ends.detach().clone(),
                                    sigma.detach().clone(), ray_indices.clone(),
                                    valid.clone(), group)]
        return weights_of(t_starts, t_ends, sigma, ray_indices, valid, group=group)

    nerf_model.accumulate_along_rays = capturing
    nerf_model.render_weight_from_density = capturing_weights
    try:
        fig["run"] = dataset_launcher_phase(device, smi, "jpeg_colmap_nerf")
    finally:
        nerf_model.accumulate_along_rays = accumulate
        nerf_model.render_weight_from_density = weights_of
    assert captured, "no training step composited through accumulate_along_rays"
    assert weights_captured, "no training step through render_weight_from_density"
    fig["vjp"] = compositing_vjp_check(captured[0], smi)
    fig["segmented_cumsum"] = segmented_cumsum_check(weights_captured[0], smi)
    return fig


def segmented_cumsum_check(operands, smi):
    """Queue 3 item 11: the segmented prefix sum's backward
    (``ops/rendering.py`` ``SegmentedInclusiveCumsum``: the cotangent's
    segmented sum read from the right, gathers only) against autograd
    through the same float64 forward (``segmented_inclusive_prefix``, whose
    gathers' backward is PyTorch's float64 ``indexing_backward_kernel``) on
    a training step's captured ``render_weight_from_density`` operands and
    that step's distortion loss (midpoints and intervals of the same
    samples): the forwards equal to the bit, d sigma, d weights and d
    midpoints within 1e-6 x max|grad|, both paths computed with PyTorch's
    deterministic algorithms on (its CUDA float cumsum otherwise adds in an
    order that varies from run to run, which can move a float32 rounding);
    each backward timed, with that mode off, with CUDA events back to back
    and queued behind a spin kernel (device time)."""
    import contextlib

    from instant_nsr_pl_tpu_torch.ops import rendering
    from instant_nsr_pl_tpu_torch.tools.microbench_gather import time_ms as queued_ms

    ts, te, sigma0, ray_indices, valid, group = operands
    gen = torch.Generator(device=sigma0.device).manual_seed(SEED)
    ct = torch.randn(sigma0.shape, generator=gen, device=sigma0.device)
    n_rays = int(ray_indices.max()) + 1
    fig = {"samples": sigma0.shape[0], "live": int(valid.sum()), "group": group}
    got = {}
    custom = rendering._segmented_inclusive_cumsum

    @contextlib.contextmanager
    def deterministic():
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)

    try:
        for name in ("custom", "autograd"):
            rendering._segmented_inclusive_cumsum = (
                custom if name == "custom"
                else lambda flags, x: rendering.segmented_inclusive_prefix(flags, x)[0])
            sigma = sigma0.clone().requires_grad_()
            with deterministic():
                w = rendering.render_weight_from_density(ts, te, sigma, ray_indices, valid,
                                                         group)
                (d_sigma,) = torch.autograd.grad(w, sigma, ct)
                wl = w.detach().clone().requires_grad_()
                mid = (0.5 * (ts + te)).requires_grad_()
                loss = rendering.distortion_loss(wl, mid, te - ts, ray_indices, valid, n_rays,
                                                 group=group)
                got[name] = (w.detach(), d_sigma, loss.detach(),
                             *torch.autograd.grad(loss, (wl, mid)))
            w = rendering.render_weight_from_density(ts, te, sigma, ray_indices, valid, group)

            def backward(w=w, sigma=sigma):
                return torch.autograd.grad(w, sigma, ct, retain_graph=True)

            fig[f"{name}_ms"] = time_ms(backward)
            fig[f"{name}_device_ms"] = queued_ms(backward, inner=1)
    finally:
        rendering._segmented_inclusive_cumsum = custom
    for i, key in ((0, "weights"), (2, "distortion")):
        assert torch.equal(got["custom"][i], got["autograd"][i]), f"the {key} forward changed"
    for i, key in ((1, "d_sigma"), (3, "d_weights"), (4, "d_midpoints")):
        ref = float(got["autograd"][i].abs().max())
        fig[f"{key}_max_abs_diff"] = float((got["custom"][i] - got["autograd"][i]).abs().max())
        fig[f"{key}_max_abs"] = ref
        assert ref > 0 and fig[f"{key}_max_abs_diff"] <= 1e-6 * ref, (key, fig)
    print(f"[segmented-cumsum] a training step's operands ({fig['samples']} samples, "
          f"{fig['live']} live, blocks of {group}): weights and distortion loss equal to the "
          f"bit; largest difference d sigma {fig['d_sigma_max_abs_diff']:.3e} (max |grad| "
          f"{fig['d_sigma_max_abs']:.3e}), d weights {fig['d_weights_max_abs_diff']:.3e} "
          f"({fig['d_weights_max_abs']:.3e}), d midpoints {fig['d_midpoints_max_abs_diff']:.3e} "
          f"({fig['d_midpoints_max_abs']:.3e}); the weights' backward: custom "
          f"{fig['custom_ms']:.4f} ms (device {fig['custom_device_ms']:.4f}), autograd "
          f"{fig['autograd_ms']:.4f} ms (device {fig['autograd_device_ms']:.4f}) ({smi})",
          flush=True)
    return fig


# ---------------------------------------------------------------------------
# slice 15: data-parallel training through the launcher's --devices
# ---------------------------------------------------------------------------

DP_STEPS = 100  # of nerf-blender.yaml's 20,000
DP_EMULATE = 30  # the step held against rank 0's single-rank emulation
DP_WARM = 40  # the timed steps: DP_WARM to DP_STEPS - 1 (grid updates every 16 included)
DP_WS1_STEPS = 12  # world size 1 over NCCL
DP_KERNELS = ("hashgrid_forward", "hashgrid_backward", "sh_mlp_forward", "sh_mlp_backward")


def dp_phase(device, smi, untrained_test):
    """Slice 15: ``configs/nerf-blender.yaml`` at full width on
    ``data80/blender`` (the Blender runs' overrides) through the port's
    launcher with ``--devices 2``: over NCCL on two cards, else both ranks
    on this card over gloo. The ranks are observed by
    ``tools/dp_check.py`` ``observe`` around the system's own step: each
    step's HG1 / HG2 / K3 / K4 launches on every rank; the ranks' batches
    differ at every step; the grid, parameters and AdamW moments (and the
    extra state and generator) equal to the bit across the ranks (sha256)
    after the first grid update and at the end; step DP_EMULATE's mean
    gradients and parameter updates within 2.5e-2 of rank 0's single-rank
    emulation's largest per tensor (the card step checks' K4 limit), the
    emulation's rebuilt batches the ones the ranks drew; the
    warm per-rank step wall and the gradient all-reduce's share (CUDA
    events). The loss falls; the val views (2) end at least 3 dB above the
    untrained model's, and test/psnr is printed beside ``untrained_test``;
    rank 0's mesh marches on the card. Then DP_WS1_STEPS steps at world size
    1 over NCCL (``--devices 1 --backend nccl``, the test split cut to the
    val views): NCCL's set-up and all-reduce on the card. Returns the
    figures."""
    import csv
    import functools
    import glob

    from instant_nsr_pl_tpu_torch.tools import dp_check

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    config = os.path.join(ROOT, "configs", "nerf-blender.yaml")
    untrained = _untrained_psnr(config, BLENDER_DATA, "val", 2, device)
    print(f"[dp] world size 2, backend {backend}, {cards} visible card(s); untrained val "
          f"PSNR over 2 views {untrained:.3f} dB ({smi})", flush=True)
    fig = {"world": 2, "backend": backend, "cards": cards, "untrained_val": untrained}
    exp = os.path.join(ROOT, "exp", "chip_smoke_dp")
    shutil.rmtree(exp, ignore_errors=True)
    base = ["--config", config, "tag=chip", *BLENDER_DATA]
    runs = {}
    for key, world, extra, steps in (
            ("dp2", 2, ["--devices", "2"] + (["--backend", "gloo"] if backend == "gloo" else []),
             DP_STEPS),
            ("ws1", 1, ["--devices", "1", "--backend", "nccl", "dataset.test_split=val"],
             DP_WS1_STEPS)):
        report = os.path.join(exp, f"{key}.json")
        hook = functools.partial(dp_check.observe, out=report,
                                 emulate_at=DP_EMULATE if key == "dp2" else 2,
                                 warm_from=DP_WARM if key == "dp2" else 4)
        wall = _launcher_run(base + extra + [
            "--exp_dir", os.path.join(exp, key), "--train", f"trainer.max_steps={steps}",
            f"trainer.val_check_interval={steps}", "trainer.log_every_n_steps=20"],
            rank_hook=hook)
        records = dp_check.read_report(report)
        assert len(records) == world, records
        missing = dp_check.launches_each_step(records, DP_KERNELS)
        assert not missing, f"{key}: steps without a kernel launch: {missing[:10]}"
        for label in ("digests_first_update", "digests_end"):
            assert dp_check.agree(records, label), (key, label, [r[label] for r in records])
        same = dp_check.same_batches(records)
        assert not same, f"{key}: ranks drew equal batches at steps {same[:10]}"
        emu = records[0]["emulation"]
        assert emu is not None and emu["grad_share"] <= emu["rel"], emu
        assert dp_check.emulation_batches_match(records), (key, emu["batches"])
        (run,) = glob.glob(os.path.join(exp, key, "*", "chip@*"))
        with open(os.path.join(run, "csv_logs", "metrics.csv")) as fh:
            rows = list(csv.DictReader(fh))
        val = [float(r["val/psnr"]) for r in rows if r.get("val/psnr")]
        test = [float(r["test/psnr"]) for r in rows if r.get("test/psnr")]
        losses = [s["loss"] for s in records[0]["steps"]]
        k = max(len(losses) // 5, 1)
        first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        runs[key] = {"wall_s": wall, "val": val[-1], "test": test[-1], "first": first,
                     "last": last, "records": records}
        warm = [r["warm"] for r in records]
        per_rank = "; ".join(
            f"rank {r['rank']} ({r['device']}) {w['ms_per_step']:.2f} ms a step, all-reduce "
            f"{w['reduce_ms_per_step']:.3f} ms ({w['reduce_share']:.1%})"
            for r, w in zip(records, warm))
        print(f"[dp] {key}: {steps} steps + val + test + mesh through the launcher in "
              f"{wall:.1f} s (world {world}, {records[0]['backend']}); warm steps "
              f"{DP_WARM if key == 'dp2' else 4}-{steps - 1}: {per_rank}; loss, first {k} "
              f"steps {first:.5f}, last {k} {last:.5f}; val PSNR {val[-1]:.3f} dB (untrained "
              f"{untrained:.3f}), test/psnr {test[-1]:.3f} (untrained {untrained_test:.3f}); "
              f"step {emu['step']} against rank 0's emulation: mean gradients within "
              f"{emu['grad_share']:.3e}, updates within {emu['update_share']:.3e} of the "
              f"largest (limit {emu['rel']}), its batches the ones the ranks drew, which "
              f"differ at every step; digests agree after the first grid update and "
              f"at the end ({records[0]['digests_end']['params'][:12]}...); launches "
              f"{[r['launches_run'] for r in records]} ({smi})", flush=True)
        assert np.isfinite(losses).all(), f"{key}: the loss went non-finite"
        if key == "dp2":
            assert last < first, f"{key}: the loss did not fall"
            assert val[-1] >= untrained + 3.0, f"{key}: training gained less than 3 dB"
            assert records[0]["launches_run"]["marching_classify"] >= 1, "no marching on the card"
    fig["runs"] = runs
    torch.cuda.empty_cache()
    return fig


# ---------------------------------------------------------------------------
# slice 10: the VM encoding (VM1 / VM2), the VM NeRF at the JAX package's VM
# width, and marching tetrahedra on the card (MT1 / MT2)
# ---------------------------------------------------------------------------

VM_CONFIG = os.path.join(CONFIGS, "nerf-vm-synthetic.yaml")
VM_RUN = {}  # the VM NeRF's figures (train_phase, vm_mesh_phase)
VM_PROFILED_STEPS = range(81, 91)  # warm steps without a grid update, before the timed 100
MARCHING_DIR = os.path.join(ROOT, "exp", "chip_smoke_marching")
SPHERE_RES = (128, 256, 512)
EXPORT_GRID_RES = 256  # the VM NeRF's level grid held against the numpy twin
TWINS = []  # the numpy twins' processes (started early, joined in marching_phase)
TWIN_ISO = {}  # their grids' iso levels


def vm_spec():
    """The VM NeRF's encoding (``nerf-vm-synthetic.yaml``: scripts/ab_encodings.py:44-48)."""
    from instant_nsr_pl_tpu_torch.ops.vm import VMSpec

    return VMSpec.from_config(bench_config(VM_CONFIG)["model"]["geometry"]["xyz_encoding_config"])


def vm_check(tag, params, x, ct, spec, with_dx=True):
    """VM1 (``ct`` None) or VM2 against its plain version on the same CUDA
    tensors: VM1 equal to it to the bit, VM2's table gradients within 1e-5 x
    max|ref| per table of the float64 sum of the plain updates, its d x
    within 1e-4 x max|plain| and equal to the bit in a second launch.
    Returns the largest errors (forward, backward)."""
    from instant_nsr_pl_tpu_torch.ops import vm

    errs = [0.0, 0.0]
    if ct is None:
        got = vm.vm_forward_launch(params, x, spec)
        torch.cuda.synchronize()
        ref = vm.vm_encode(params, x, spec)
        same = float((got == ref).float().mean())
        err = float((got - ref).abs().max())
        print(f"[kernel] vm_forward {tag}: {same:.6%} of the entries equal the plain version's "
              f"to the bit; max|kernel - plain| {err:.3e} (limit: equal to the bit)",
              flush=True)
        if not torch.equal(got, ref):
            raise AssertionError(f"vm_forward {tag} disagrees with its plain version")
        errs[0] = err
        return errs
    dparams, dx = vm.vm_backward_launch(params, x, ct, spec, with_dx=with_dx)
    torch.cuda.synchronize()
    ref, rdx = vm.vm_backward_plain(params, x, ct, spec, with_dx=with_dx,
                                    accumulate=torch.float64)
    worst = 0.0  # the largest error of a table over its max|ref|
    for k in spec.keys():
        e = float((dparams[k].double() - ref[k]).abs().max())
        scale = float(ref[k].abs().max())
        if not e <= 1e-5 * scale:
            raise AssertionError(f"vm_backward {tag} {k}: {e:.3e} > 1e-5 x {scale:.3e}")
        worst = max(worst, e / max(scale, 1e-30))
        errs[1] = max(errs[1], e)
    print(f"[kernel] vm_backward {tag}: table gradients within {worst:.3e} x max|ref| per table "
          f"(limit 1e-5, float64 reference)", flush=True)
    if with_dx and dx is not None:
        errs[1] = max(errs[1], compare(f"vm_backward {tag} d x", dx, rdx, rel=1e-4))
        _, dx2 = vm.vm_backward_launch(params, x, ct, spec, with_dx=True)
        if not torch.equal(dx, dx2):
            raise AssertionError(f"vm_backward {tag}: d x differs between two launches")
    return errs


def check_vm_step(key, calls):
    """``capture_step_operands``' check for a VM NeRF step: every VM1 / VM2
    launch of the step held against its plain version on its own operands."""
    if key not in ("vm_forward", "vm_backward"):
        return
    for i, (args, kwargs) in enumerate(calls):
        if key == "vm_forward":
            params, x, spec = args[:3]
            vm_check(f"step launch {i} (N={x.shape[0]})", params, x, None, spec)
        else:
            params, x, dout, spec = args[:4]
            with_dx = bool(args[4] if len(args) > 4 else kwargs.get("with_dx", False))
            vm_check(f"step launch {i} (N={x.shape[0]})", params, x, dout, spec, with_dx)


def _vm_taps(spec, x):
    """Every table's (rows (T, N), weights (T, N)) for the plain yardsticks
    and the bound's distinct rows."""
    from instant_nsr_pl_tpu_torch.ops import vm

    taps = {}
    for s in range(spec.n_scales):
        rp = spec.plane_res(s)
        for k, axes in enumerate(vm.VMSpec.AXES):
            taps[f"plane_{s}_{k}"] = vm._plane_taps(x, axes, rp)
            taps[f"line_{s}_{k}"] = vm._line_taps(x, axes, spec.line_resolution)
    return taps


def vm_bounds(spec, x):
    """VM1's and VM2's bounds on the positions x: (ms, by) each, and the
    distinct table rows x touches. Bytes: x and the output (VM1) or its
    cotangent (VM2) per sample, each touched row read once, and for VM2 the
    whole gradient written once; operations: the 6 taps' multiply-adds and
    the product per component (VM2 twice that)."""
    n, c = x.reshape(-1, 3).shape[0], spec.n_components
    distinct = sum(int(torch.unique(rows).numel()) for rows, _ in _vm_taps(spec, x).values())
    table_bytes = c * 4 * 3 * sum(spec.plane_res(s) ** 2 + spec.line_resolution
                                  for s in range(spec.n_scales))
    read = n * (12 + spec.n_output_dims * 4) + distinct * c * 4
    flops = n * 3 * spec.n_scales * c * (2 * 6 + 1)
    return bound(read, 0, flops), bound(read + table_bytes, 0, 2 * flops), distinct


def vm_kernel_phase(device):
    """VM1 (the VM encoding forward) and VM2 (its table gradients, and d x
    on request) at the VM NeRF's width (C = 16, planes 512^2 and 256^2,
    lines 2048, 2 scales: 96 features), N = 262,144 and 262,107 uniform
    points with samples at u = 0 and 1 on every axis, against their plain
    versions on the same CUDA tensors (``vm_check``); then timed beside
    their bounds (bytes: x and the output or cotangent per sample, each
    table row the points touch read once, VM2's whole gradient written once),
    the plain versions and the composed yardsticks the port never calls
    (VM1: ``index_select`` and the weighted sums on precomputed taps; VM2:
    one ``index_add_`` per table on precomputed updates)."""
    from instant_nsr_pl_tpu_torch.ops import vm

    spec = vm_spec()
    gen = torch.Generator().manual_seed(SEED + 19)
    params = vm.vm_init(gen, spec, device)
    x = torch.rand((N_FULL, 3), generator=gen)
    x[:8] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.25, 0.0],
                          [0.5, 1.0, 1.0], [1 / 511, 0.5, 1 - 1 / 2047], [0.999999, 1e-7, 0.5],
                          [0.5, 0.5, 0.5]])
    x = x.to(device)
    ct = torch.randn((N_FULL, spec.n_output_dims), generator=gen).to(device)
    errs = {"vm_forward": [], "vm_backward": []}
    for n in (N_RAGGED, N_FULL):
        xn, ctn = x[:n], ct[:n].contiguous()
        fe, _ = vm_check(f"N={n}", params, xn, None, spec)
        _, be = vm_check(f"N={n}", params, xn, ctn, spec, with_dx=True)
        _, be2 = vm_check(f"N={n} (no d x)", params, xn, ctn, spec, with_dx=False)
        errs["vm_forward"].append(fe)
        errs["vm_backward"] += [be, be2]
    # through the autograd op (the training path: the same VM1 launch)
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    (vm.vm_encode_fast(leaves, x, spec) * ct).sum().backward()
    torch.cuda.synchronize()
    ref, _ = vm.vm_backward_plain(params, x, ct, spec, accumulate=torch.float64)
    for k in spec.keys():
        e = float((leaves[k].grad.double() - ref[k]).abs().max())
        if not e <= 1e-5 * float(ref[k].abs().max()):
            raise AssertionError(f"vm_encode_fast d {k}: {e:.3e}")

    n = N_FULL
    c = spec.n_components
    taps = _vm_taps(spec, x)
    (fwd_bound, fwd_by), (bwd_bound, bwd_by), distinct = vm_bounds(spec, x)
    ms = time_ms(lambda: vm.vm_forward_launch(params, x, spec))
    ms_train = time_ms(lambda: vm.vm_encode_fast(leaves, x, spec))
    dev = device_ms(lambda: vm.vm_forward_launch(params, x, spec))
    plain_ms = time_ms(lambda: vm.vm_encode(params, x, spec), reps=5, inner=2)

    def gathered():
        return [vm._gather_weighted(params[k], *taps[k]) for k in spec.keys()]
    composed_ms = time_ms(gathered, reps=5, inner=2)
    bms = time_ms(lambda: vm.vm_backward_launch(params, x, ct, spec))
    bms_dx = time_ms(lambda: vm.vm_backward_launch(params, x, ct, spec, with_dx=True))
    bdev = device_ms(lambda: vm.vm_backward_launch(params, x, ct, spec))
    bplain_ms = time_ms(lambda: vm.vm_backward_plain(params, x, ct, spec), reps=5, inner=2)
    # precomputed updates per table (as the JAX backward forms them), one index_add_ each
    ct2 = ct.reshape(n, 3 * spec.n_scales, c)
    feats = {k: f for k, f in zip(spec.keys(), gathered())}
    updates = []
    for j in range(3 * spec.n_scales):
        pk, lk = spec.keys()[2 * j], spec.keys()[2 * j + 1]
        g = ct2[:, j]
        for key, other in ((pk, feats[lk]), (lk, feats[pk])):
            rows, w = taps[key]
            updates.append((key, rows.reshape(-1), (w[..., None] * (g * other)[None]).reshape(-1, c)))
    grads = {k: torch.zeros_like(t) for k, t in params.items()}

    def scatter():
        for key, rows, upd in updates:
            grads[key].zero_()
            grads[key].index_add_(0, rows, upd)
    bcomposed_ms = time_ms(scatter)
    print(f"[kernel] vm_forward: {ms:.4f} ms, {ms_train:.4f} ms through the autograd op (device "
          f"{dev:.4f} ms; plain {plain_ms:.3f} ms; index_select and weighted sums on precomputed "
          f"taps {composed_ms:.4f} ms; bound {fwd_bound:.4f} ms by {fwd_by}: {distinct} distinct "
          f"rows of {sum(t.shape[0] for t in params.values())}) at N={n}", flush=True)
    print(f"[kernel] vm_backward: {bms:.4f} ms, {bms_dx:.4f} ms with d x (device {bdev:.4f} ms, "
          f"the zeroing included; plain {bplain_ms:.3f} ms; one index_add_ per table on "
          f"precomputed updates {bcomposed_ms:.4f} ms; bound {bwd_bound:.4f} ms by {bwd_by}) at "
          f"N={n}", flush=True)
    note = ("no single PyTorch call forms the bilinear plane and linear line taps and their "
            "products (or scatters all twelve tables' updates)")
    common = {"route": "cuda", "launches": 0, "library_ms": None, "library_note": note, "n": n,
              "distinct_rows": distinct}
    return [
        {**common, "name": "vm_forward", "source": "instant_nsr_pl_tpu_torch/csrc/vm_fwd.cu",
         "replaces": "instant_nsr_pl_tpu/ops/vm.py:136 (vm_encode, XLA; vm_encode_fast :166)",
         "max_abs_err": max(errs["vm_forward"]), "ms": ms, "ms_train": ms_train,
         "device_ms": dev, "plain_ms": plain_ms, "composed_ms": composed_ms,
         "bound_ms": fwd_bound, "bound_by": fwd_by,
         "ptxas": ptxas_info("vm_fwd", f"vm_fwd_kernelILi{c}E")},
        {**common, "name": "vm_backward", "source": "instant_nsr_pl_tpu_torch/csrc/vm_bwd.cu",
         "replaces": "instant_nsr_pl_tpu/ops/vm.py:176 (_vm_fast_bwd, XLA two-sort segment sum "
                     "ops/segment.py:28)",
         "max_abs_err": max(errs["vm_backward"]), "ms": bms, "ms_with_dx": bms_dx,
         "device_ms": bdev, "plain_ms": bplain_ms, "composed_ms": bcomposed_ms,
         "bound_ms": bwd_bound, "bound_by": bwd_by,
         "ptxas": ptxas_info("vm_bwd", f"vm_bwd_kernelILi{c}ELb0E")},
    ]


def mt_counters():
    from instant_nsr_pl_tpu_torch.ops import isosurface

    return {"marching_classify": isosurface.marching_classify,
            "marching_emit": isosurface.marching_emit}


def vm_mesh_phase(device, system, state, smi):
    """The trained VM NeRF's mesh: its two-stage extraction at the config's
    128^3 (VM1 in the level grids, MT1 / MT2 on the card, the counters set
    to 0 just before and read just after), a non-empty mesh with valid
    indices; then its level grid at EXPORT_GRID_RES^3 kept on the card for
    ``marching_phase``."""
    from instant_nsr_pl_tpu_torch.models.isosurface import _eval_level_grid
    from instant_nsr_pl_tpu_torch.ops import vm

    geo = system.model.geometry
    counters = {**mt_counters(), "vm_forward": vm.vm_forward, "vm_backward": vm.vm_backward}
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = geo.isosurface(state["params"]["geometry"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    print(f"[train-vm] mesh at {int(geo.config.isosurface.resolution)}^3 in {wall:.3f} s: "
          f"{len(v)} vertices, {len(f)} faces; launches {launches} ({smi})", flush=True)
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v), "empty or broken mesh"
    assert launches["marching_classify"] >= 1 and launches["marching_emit"] >= 1, launches
    assert launches["vm_forward"] >= 1 and launches["vm_backward"] == 0, launches
    VM_RUN.update(vertices=len(v), faces=len(f), mesh_s=wall, mesh_launches=launches)
    r = float(geo.radius)
    lo, hi = np.full(3, -r, np.float32), np.full(3, r, np.float32)
    with torch.no_grad():
        grid = _eval_level_grid(geo, state["params"]["geometry"], lo, hi, EXPORT_GRID_RES,
                                int(geo.config.isosurface.chunk), device)
    EXPORT_GRIDS["vm_nerf_level"] = (grid, -float(geo.config.isosurface.threshold))


EXPORT_GRIDS = {}  # name -> (the level grid on the card, iso)


def sphere_grid(res):
    """A sphere SDF of radius 0.6 about (0.05, -0.1, 0.02) on a res^3 grid
    over [-1, 1]^3, float32 (the numpy twin's test field)."""
    c = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return np.sqrt((x - 0.05) ** 2 + (y + 0.1) ** 2 + (z - 0.02) ** 2).astype(np.float32) - 0.6


def start_twin(name, values, iso):
    """Save ``values`` and run the numpy twin on it in a process of its own
    (``python3 chip_smoke.py --twin``, at a lower priority), beside the
    card's kernel phases; its result and seconds land in
    MARCHING_DIR/<name>-twin.npz."""
    os.makedirs(MARCHING_DIR, exist_ok=True)
    path = os.path.join(MARCHING_DIR, f"{name}.npy")
    np.save(path, values)
    with open(os.path.join(MARCHING_DIR, f"{name}.iso.json"), "w") as fh:
        json.dump({"iso": iso}, fh)  # for tools/mt_bench.py --grids
    TWIN_ISO[name] = iso
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--twin", path, repr(iso)],
                            cwd=ROOT)
    TWINS.append((name, proc))


NEUS_FINE = "neus_blender_fine_512"  # the trained neus-blender's fine level grid
NEUS_ISO_RES = 512  # configs/neus-blender.yaml isosurface.resolution


def neus_fine_grid_phase(blender_neus, smi):
    """The ``blender_neus`` run's model exported uncut: ``--export`` of its
    checkpoint at the config's own ``isosurface.resolution`` (512), timed by
    stage; the fine pass's level grid (the last marched) is saved and its
    numpy twin started in a process of its own (``start_twin``), held in
    ``marching_phase``. Returns the export's figures."""
    import glob

    import instant_nsr_pl_tpu_torch.models.isosurface as iso_model
    from instant_nsr_pl_tpu_torch.tools.launch_timed import timed_export
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj

    ckpt = os.path.join(blender_neus["run"], "ckpt", f"step={LAUNCHER_STEPS}.ckpt")
    grids, stage = [], {}
    march = iso_model.marching_tetrahedra

    def keep(values, iso=0.0):
        grids.append((values, float(iso)))
        return march(values, iso)

    iso_model.marching_tetrahedra = keep
    try:
        with timed_export(stage):
            wall = _launcher_run(blender_neus["base_args"] + [
                "--export", "--resume", ckpt,
                f"model.geometry.isosurface.resolution={NEUS_ISO_RES}"])
    finally:
        iso_model.marching_tetrahedra = march
    (obj,) = glob.glob(os.path.join(blender_neus["run"], "save", "*.obj"))
    mesh = load_obj(obj)
    values, iso = grids[-1]
    assert tuple(values.shape) == (NEUS_ISO_RES,) * 3, values.shape
    start_twin(NEUS_FINE, values.cpu().numpy(), iso)
    rest = stage["export"] - stage["level grid"] - stage["marching"] - stage["vertex colours"]
    out = {"export_s": wall, "stages": dict(stage), "rest_s": rest,
           "vertices": len(mesh["v_pos"]), "faces": len(mesh["t_pos_idx"]), "iso": iso}
    print(f"[blender_neus] --export at {NEUS_ISO_RES}^3 (uncut) {wall:.2f} s: {out['vertices']} "
          f"vertices, {out['faces']} faces; level grid {stage['level grid']:.3f} s (2 grids), "
          f"marching {stage['marching']:.3f} s (card, 2 passes), vertex colours "
          f"{stage['vertex colours']:.3f} s, the rest (OBJ) {rest:.3f} s ({smi})", flush=True)
    assert out["faces"] > 0
    return out


def run_twin(path, iso):
    """The ``--twin`` mode: the numpy twin of MT1 / MT2 on a saved grid, timed."""
    os.nice(10)  # the main process's host work first
    sys.path.insert(0, ROOT)
    from instant_nsr_pl_tpu_torch.ops.isosurface import marching_tetrahedra_numpy

    values = np.load(path)
    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra_numpy(values, iso)
    seconds = time.perf_counter() - t0
    np.savez(path[:-len(".npy")] + "-twin.npz", verts=verts, faces=faces, seconds=seconds)
    return 0


def stop_twins():
    for _, proc in TWINS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _ulps(a, b):
    """Units in the last place between float32 arrays a and b (elementwise)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def obj_writer_check(v, f, smi):
    """The largest mesh of the run through ``utils/savers.py`` ``save_obj``
    (``obj_writer.cc``), timed, against the same lines formatted by Python's
    ``%`` as the writer did before (and as the JAX package's does): the same
    bytes. Returns the seconds of both."""
    from instant_nsr_pl_tpu_torch.utils.savers import save_obj

    t0 = time.perf_counter()
    path = save_obj(MARCHING_DIR, "largest.obj", v, f)
    writer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = ["v %.6f %.6f %.6f" % tuple(p) for p in v.tolist()]
    lines += ["f %d %d %d" % tuple(t) for t in (f + 1).tolist()]
    python = ("\n".join(lines) + "\n").encode()
    python_s = time.perf_counter() - t0
    with open(path, "rb") as fh:
        same = fh.read() == python
    print(f"[obj] {len(v)} vertices, {len(f)} faces: save_obj {writer_s:.3f} s, the lines "
          f"formatted by Python {python_s:.3f} s; the same bytes: {same} ({smi})", flush=True)
    assert same, "save_obj's bytes differ from Python's formatting"
    return {"vertices": len(v), "faces": len(f), "save_obj_s": writer_s, "python_s": python_s}


def mt_turns(parent, grids):
    """``tools/mt_bench.py`` on ``grids`` from the parent checkout and from
    this one in turns (parent, change, change, parent), each in a process of
    its own. Returns {"parent": [result, result], "change": [...]}."""
    runs = {"parent": [], "change": []}
    for i, (label, root) in enumerate((("parent", parent), ("change", ROOT), ("change", ROOT),
                                       ("parent", parent))):
        out = os.path.join(MARCHING_DIR, f"turn{i}-{label}.json")
        subprocess.run([sys.executable, os.path.join(ROOT, "instant_nsr_pl_tpu_torch", "tools",
                                                     "mt_bench.py"),
                        "--root", os.path.abspath(root), "--grids", ",".join(grids), "--out", out],
                       check=True, timeout=900, cwd=ROOT)
        with open(out) as fh:
            runs[label].append(json.load(fh))
    return runs


def marching_phase(device, smi, parent=None):
    """MT1 / MT2 against the numpy twin on the sphere SDF at SPHERE_RES^3 and
    on the trained neus-blender's 512^3 fine level grid (those twins ran in
    their own processes beside the card's phases) and on the VM NeRF's level
    grid at EXPORT_GRID_RES^3 (its twin runs here): faces equal, vertices
    equal to the bit or within 1 ulp (the count of differing vertices
    printed); the card's marching wall (synchronised, warm) against the
    twin's seconds, its device ms by kernel (torch.profiler) and its stages
    (``tools/mt_bench.py`` ``stage_split``: an event after each stage); MT1
    (classify and scan) and MT2 (the sync, emit, vertices) alone timed at
    512^3 beside their bounds, re-counted for this design and the first
    design's beside them; given ``parent``, ``tools/mt_bench.py`` from that
    checkout and this one in turns. Returns the two kernel entries."""
    from instant_nsr_pl_tpu_torch.ops import cuda_build
    from instant_nsr_pl_tpu_torch.ops import isosurface as iso_mod
    from instant_nsr_pl_tpu_torch.tools import mt_bench

    for name, proc in TWINS:
        rc = proc.wait(timeout=900)
        assert rc == 0, f"the numpy twin of {name} exited {rc}"
    grids = {name: (None, TWIN_ISO[name]) for name, _ in TWINS}
    grids.update(EXPORT_GRIDS)
    results = {}
    counters = mt_counters()
    timing = {}
    for name, (grid, iso) in grids.items():
        if grid is None:
            grid = torch.from_numpy(np.load(os.path.join(MARCHING_DIR, f"{name}.npy"))).to(device)
            twin = np.load(os.path.join(MARCHING_DIR, f"{name}-twin.npz"))
        else:
            t0 = time.perf_counter()
            rv, rf = iso_mod.marching_tetrahedra_numpy(grid.cpu().numpy(), iso)
            twin = {"verts": rv, "faces": rf, "seconds": time.perf_counter() - t0}
        before = {k: c.launches for k, c in counters.items()}
        walls = []
        for _ in range(4):  # the first cold
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, f = iso_mod.marching_tetrahedra(grid, iso)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls[1:])
        dev_ms, by_kernel = mt_bench.device_split(lambda: iso_mod.marching_tetrahedra(grid, iso))
        dev_ms = dev_ms if by_kernel else None  # the profiler recorded no device activity
        split, split_sum = mt_bench.stage_split(iso_mod, cuda_build, grid, iso, 5)
        for c, b in zip(counters.values(), before.values()):
            c.launches = b  # the comparison's launches are not a path's
        v, f = v.cpu().numpy(), f.cpu().numpy()
        rv, rf = twin["verts"], twin["faces"]
        if f.shape != rf.shape or not np.array_equal(f, rf):
            raise AssertionError(f"marching {name}: faces differ from the numpy twin's "
                                 f"({f.shape} against {rf.shape})")
        assert v.shape == rv.shape, (v.shape, rv.shape)
        ulps = _ulps(v, rv)
        differ = int((ulps.max(axis=1) > 0).sum()) if len(v) else 0
        worst = int(ulps.max()) if len(v) else 0
        print(f"[marching] {name} ({tuple(grid.shape)}, iso {iso}): {len(v)} vertices, {len(f)} "
              f"faces; faces equal to the numpy twin's, {differ} vertices differ (at most {worst} "
              f"ulp); card {wall * 1e3:.3f} ms warm (synchronised; cold {walls[0] * 1e3:.3f}), "
              + (f"device {dev_ms:.4f} ms (" + ", ".join(
                  f"{k[:40]} {t:.4f}" for k, t in sorted(by_kernel.items(), key=lambda kv: -kv[1]))
                 + ")" if by_kernel else "device ms not measured (the profiler saw no kernel)")
              + "; stages " + ", ".join(f"{k} {t:.4f}" for k, t in split.items())
              + f" (sum {split_sum:.4f} ms); numpy twin {float(twin['seconds']):.3f} s on the "
              f"host ({smi})", flush=True)
        if worst > 1:
            raise AssertionError(f"marching {name}: vertices differ by {worst} ulp")
        results[name] = {"vertices": len(v), "faces": len(f), "card_ms": wall * 1e3,
                         "card_ms_cold": walls[0] * 1e3, "device_ms": dev_ms,
                         "device_by_kernel": by_kernel, "stages_ms": split,
                         "twin_s": float(twin["seconds"]), "vertices_differ": differ,
                         "max_ulp": worst}
        assert len(f) > 0, f"marching {name}: empty mesh"
        if name == f"sphere_{SPHERE_RES[-1]}":
            timing = {"grid": grid, "iso": iso, "verts": len(v), "faces": len(f)}
            results["obj_writer"] = obj_writer_check(v, f, smi)
        del grid
    grid, iso = timing["grid"], timing["iso"]
    classified = iso_mod.marching_classify(grid, iso)
    active = int(classified.totals[0])
    keep = {k: c.launches for k, c in counters.items()}
    ms1 = time_ms(lambda: iso_mod.marching_classify(grid, iso), reps=5, inner=3)
    ms2 = time_ms(lambda: iso_mod.marching_emit(grid, iso, classified), reps=5, inner=3)
    for k, c in counters.items():
        c.launches = keep[k]
    n_cells = grid.numel()
    n_lines = grid.shape[0] * grid.shape[1]
    n_tiles = -(-n_lines // iso_mod.LINES_PER_TILE)
    cubes = math.prod(d - 1 for d in grid.shape)
    faces, verts = timing["faces"], timing["verts"]
    # MT1: the grid once; a byte per grid vertex, 8 B a line, 24 B a tile
    # written; the scan reads the tiles' sums and writes 16 B a tile
    b1, b1_by = bound(n_cells * 5 + n_lines * 8 + n_tiles * (24 + 24 + 16), 0, 0)
    # MT2: the active cubes' corners, 24 B a face and 12 B a vertex
    b2, b2_by = bound(active * 32 + faces * 24 + verts * 12, 0, 0)
    # the whole pass: the grid once and the mesh
    b_pass, _ = bound(n_cells * 4 + faces * 24 + verts * 12, 0, 0)
    # the first design's bounds: its counts (a byte per cube) written; its
    # MT2 the active cubes' ids and first faces, their 8 corners, 24 B of keys
    # and a flag per face, the weld's keys again and the vertices (12 B each)
    b1_old, _ = bound(n_cells * 4 + cubes, 0, 0)
    b2_old, _ = bound(active * (16 + 32) + faces * 25 + faces * 3 * 8 + verts * 20, 0, 0)
    twin_ms = results[f"sphere_{SPHERE_RES[-1]}"]["twin_s"] * 1e3
    pass_ms = results[f"sphere_{SPHERE_RES[-1]}"]["card_ms"]
    print(f"[marching] at {SPHERE_RES[-1]}^3 ({active} active cubes, {faces} faces, {verts} "
          f"vertices): MT1 (mt_classify, mt_scan) {ms1:.4f} ms (bound {b1:.4f} ms by {b1_by}; "
          f"{b1 / ms1:.0%}; the first design's bound {b1_old:.4f}), MT2 (the sync, mt_emit, "
          f"mt_verts) {ms2:.4f} ms (bound {b2:.4f} ms by {b2_by}; {b2 / ms2:.0%}; the first "
          f"design's bound {b2_old:.4f}); the pass {pass_ms:.4f} ms warm (bound {b_pass:.4f}); "
          f"numpy twin {twin_ms:.1f} ms ({smi})", flush=True)
    turns = None
    if parent:
        names = [n for n, _ in TWINS]
        turns = mt_turns(parent, [os.path.join(MARCHING_DIR, f"{n}.npy") if n == NEUS_FINE else n
                                  for n in names])
        for name in names:
            pw = [r["grids"][name]["warm_ms"] for r in turns["parent"]]
            cw = [r["grids"][name]["warm_ms"] for r in turns["change"]]
            pd = [r["grids"][name]["device_ms"] for r in turns["parent"]]
            cd = [r["grids"][name]["device_ms"] for r in turns["change"]]
            print(f"[marching] in turns, {name}: the pass warm, parent {pw[0]:.4f} / {pw[1]:.4f} "
                  f"-> change {cw[0]:.4f} / {cw[1]:.4f} ms; device {pd[0]:.4f} / {pd[1]:.4f} -> "
                  f"{cd[0]:.4f} / {cd[1]:.4f} ms; stages parent "
                  f"{turns['parent'][0]['grids'][name]['stages_ms']}, change "
                  f"{turns['change'][0]['grids'][name]['stages_ms']} ({smi})", flush=True)
    big = f"sphere_{SPHERE_RES[-1]}"

    def parent_stage(run, first):
        stages = run["grids"][big]["stages_ms"]
        return stages["mt_classify"] if first else sum(t for k, t in stages.items()
                                                       if k != "mt_classify")

    note = "no PyTorch call marches tetrahedra"
    common = {"route": "cuda", "launches": 0, "library_ms": None, "library_note": note,
              "plain_ms": twin_ms, "plain_note": "the numpy twin on the host, the whole pass",
              "max_abs_err": 0.0, "marching": results, "n": f"{SPHERE_RES[-1]}^3 sphere",
              "pass_ms": pass_ms, "pass_bound_ms": b_pass, "active_cubes": active,
              "parent_turns": ({k: [r["grids"] for r in v] for k, v in turns.items()}
                               if turns else None)}
    return [
        {**common, "name": "marching_classify",
         "source": "instant_nsr_pl_tpu_torch/csrc/marching_tet.cu",
         "replaces": "instant_nsr_pl_tpu/ops/native/marching_tet.cc:95 (mt_run, C++; numpy "
                     "twin ops/isosurface.py:95)",
         "ms": ms1, "bound_ms": b1, "bound_by": b1_by, "first_design_bound_ms": b1_old,
         "parent_ms": [parent_stage(r, True) for r in turns["parent"]] if turns else None,
         "ptxas": ptxas_info("marching_tet", "mt_classify_kernelIj"),
         "ptxas_wide": ptxas_info("marching_tet", "mt_classify_kernelIm"),
         "ptxas_scan": ptxas_info("marching_tet", "mt_scan_kernel")},
        {**common, "name": "marching_emit",
         "source": "instant_nsr_pl_tpu_torch/csrc/marching_tet.cu",
         "replaces": "instant_nsr_pl_tpu/ops/native/marching_tet.cc:95 (mt_run, C++; numpy "
                     "twin ops/isosurface.py:95)",
         "ms": ms2, "bound_ms": b2, "bound_by": b2_by, "first_design_bound_ms": b2_old,
         "parent_ms": [parent_stage(r, False) for r in turns["parent"]] if turns else None,
         "ptxas": ptxas_info("marching_tet", "mt_emit_kernelIj"),
         "ptxas_wide": ptxas_info("marching_tet", "mt_emit_kernelIm"),
         "ptxas_verts": ptxas_info("marching_tet", "mt_verts_kernelIj")},
    ]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one CUDA card.")
    ap.add_argument("--parent", default=None,
                    help="another checkout of the repo (for example the parent commit from "
                         "git archive): the backward kernels' times of its design are added")
    ap.add_argument("--twin", nargs=2, default=None, metavar=("GRID_NPY", "ISO"),
                    help=argparse.SUPPRESS)  # the numpy twin of a saved grid (start_twin)
    args = ap.parse_args(argv)
    if args.twin:  # a host process of the main run's: no card needed
        return run_twin(args.twin[0], float(args.twin[1]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        return _main(args)
    finally:
        stop_twins()


def _main(args):
    from instant_nsr_pl_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}", flush=True)
    # plain versions and SSIM are float32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = cuda_build.build_all()
    print(f"[build] {build_s:.1f} s for {sorted(cuda_build.BUILD_LOG) or 'cached libraries'}",
          flush=True)
    for stem in sorted(src.stem for src in cuda_build.CSRC.glob("*.cu")):
        log = cuda_build.build_log(stem) or ""  # this run's build or an earlier one's
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {stem}: {line.strip()}", flush=True)

    # the numpy twins of the sphere grids run on the host beside the card's phases
    for res in SPHERE_RES:
        start_twin(f"sphere_{res}", sphere_grid(res), 0.0)
    mt = mt_counters()
    mt_runs = {}

    def mt_tally(label, fn, *a, **kw):
        """``fn`` with MT1 / MT2's launches counted around it (every export
        and test mesh marches on the card)."""
        before = {k: c.launches for k, c in mt.items()}
        out = fn(*a, **kw)
        mt_runs[label] = {k: c.launches - before[k] for k, c in mt.items()}
        print(f"[marching] {label}: launches {mt_runs[label]}", flush=True)
        assert mt_runs[label]["marching_classify"] >= 1, f"{label}: no marching on the card"
        return out

    entries = kernel_phase(device) + cp_kernel_phase(device) + stacked_kernel_phase(device)
    hash_entries = hash_kernel_phase(device)
    hash_jac_entries = hash_jac_kernel_phase(device)
    vm_entries = vm_kernel_phase(device)
    cp_big_entries = cp_big_kernel_phase(device)
    probe_entries = probe_phase(device)
    render_launches, rays_per_s, warm_rays_per_s = render_phase(device)
    print(f"[render] rays/s: {rays_per_s:.0f} first view, {warm_rays_per_s:.0f} warm ({smi})",
          flush=True)
    step_launches, run_launches, train_rays_per_s, s_per_step = train_phase(device, smi)
    print(f"[train] rays/s: {train_rays_per_s:.0f} warm, {s_per_step:.4f} s per step ({smi})",
          flush=True)
    st_step, st_run, st_rays_per_s, st_s_per_step = train_phase(device, smi, NERF_STACKED_CONFIG,
                                                                kind="stacked")
    print(f"[train-stacked] rays/s: {st_rays_per_s:.0f} warm, {st_s_per_step:.4f} s per step "
          f"({smi})", flush=True)
    hs_step, hs_run, hs_rays_per_s, hs_s_per_step = train_phase(device, smi, HASH_CONFIG,
                                                                kind="hash")
    print(f"[train-hash] rays/s: {hs_rays_per_s:.0f} warm, {hs_s_per_step:.4f} s per step "
          f"({smi})", flush=True)
    torch.cuda.empty_cache()
    vm_step, vm_run, vm_rays_per_s, vm_s_per_step = train_phase(device, smi, VM_CONFIG,
                                                                kind="vm")
    print(f"[train-vm] rays/s: {vm_rays_per_s:.0f} warm, {vm_s_per_step:.4f} s per step; steps "
          f"{VM_PROFILED_STEPS.start}-{VM_PROFILED_STEPS.stop - 1} under torch.profiler: "
          f"{VM_RUN['device_ms_per_step']:.3f} device ms a step, "
          f"{VM_RUN['profiled_ms_per_step']:.2f} ms wall, busy {VM_RUN['busy_share']:.1%}, "
          f"{VM_RUN['device_launches_per_step']:.0f} device launches a step; val PSNR "
          f"{VM_RUN['untrained']:.3f} -> {VM_RUN['trained']:.3f} dB; mesh "
          f"{VM_RUN['vertices']} vertices ({smi})", flush=True)
    torch.cuda.empty_cache()
    cp_big_counts = cp_big_train_phase(device, smi)
    system, state, val, neus_step, neus_run, neus_rays_per_s = neus_train_phase(device, smi)
    neus_view, neus_view_first, neus_view_warm = neus_render_phase(device, system, state, val, smi)
    del system, state, val
    torch.cuda.empty_cache()
    fd_step, fd_run = neus_fd_phase(device)
    print(f"[neus] rays/s: {neus_rays_per_s:.0f} warm training; view {neus_view_first:.0f} first, "
          f"{neus_view_warm:.0f} warm ({smi})", flush=True)
    torch.cuda.empty_cache()
    system, state, val, ns_step, ns_run, ns_rays_per_s = neus_train_phase(
        device, smi, NEUS_STACKED_CONFIG)
    ns_view, ns_view_first, ns_view_warm = neus_render_phase(device, system, state, val, smi)
    del system, state, val
    print(f"[neus-stacked] rays/s: {ns_rays_per_s:.0f} warm training; view {ns_view_first:.0f} "
          f"first, {ns_view_warm:.0f} warm ({smi})", flush=True)
    torch.cuda.empty_cache()
    system, state, val, nr_step, nr_run, nr_rays_per_s = neus_train_phase(
        device, smi, NEUS_RAW_CONFIG)
    nr_view, nr_view_first, nr_view_warm = neus_render_phase(device, system, state, val, smi)
    print(f"[neus-raw] rays/s: {nr_rays_per_s:.0f} warm training; view {nr_view_first:.0f} "
          f"first, {nr_view_warm:.0f} warm ({smi})", flush=True)
    nr_launches, _, _ = mt_tally("neus_raw_trainer", trainer_phase, device, system, state, smi)
    mt_tally("sphere_sdf", sphere_extraction_phase, system.config.dataset.spheres, device)
    del system, state, val
    torch.cuda.empty_cache()
    launcher_train, launcher_export = mt_tally("nerf_launcher", launcher_phase, device, smi)
    torch.cuda.empty_cache()
    nh_step, nh_run, nh_export, nh_rays_per_s = mt_tally("neus_hash_launcher",
                                                         neus_hash_launcher_phase, device, smi)
    print(f"[neus-hash] rays/s: {nh_rays_per_s:.0f} warm training ({smi})", flush=True)
    torch.cuda.empty_cache()
    band_run, _ = mt_tally("band_launcher", band_launcher_phase, device, smi)
    torch.cuda.empty_cache()
    # slice 8: the Blender loader on data80, the DTU loader on the port's export
    ds_runs = {key: mt_tally(key, dataset_launcher_phase, device, smi, key)
               for key in ("blender_nerf", "blender_neus")}
    # slice 12: that NeuS exported uncut at 512^3, its fine level grid kept for marching_phase
    ds_runs["blender_neus"]["export_512"] = mt_tally(
        "blender_neus_export_512", neus_fine_grid_phase, ds_runs["blender_neus"], smi)
    dtu_export_s = dtu_export_phase()
    ds_runs["dtu_neus"] = mt_tally("dtu_neus", dataset_launcher_phase, device, smi, "dtu_neus")
    dtu_band_run, dtu_band_s = mt_tally(
        "dtu_band", band_launcher_phase, device, smi,
        os.path.join(ROOT, "configs", "neuralangelo-dtu-wmask.yaml"), DTU_BAND_OVERRIDES,
        "chip_smoke_dtu_band", "dtu-band")
    torch.cuda.empty_cache()
    # slice 9: unbounded scenes on the COLMAP export and on the DTU export
    colmap_export_s = colmap_export_phase()
    for key in ("colmap_nerf", "colmap_neus", "dtu_bg_neus"):
        ds_runs[key] = mt_tally(key, dataset_launcher_phase, device, smi, key)
    torch.cuda.empty_cache()
    # slice 14: the JPEG fixtures and capture, nerf-colmap.yaml on that
    # capture, the compositing VJP on its last training step
    jpeg_run = mt_tally("jpeg_colmap_nerf", jpeg_phase, device, smi)
    torch.cuda.empty_cache()
    # slice 15: nerf-blender.yaml through the launcher with --devices 2 (and
    # world size 1 over NCCL); the ranks' own launch counts
    dp_run = dp_phase(device, smi, ds_runs["blender_nerf"]["untrained"])
    # slice 10: MT1 / MT2 against the numpy twin (sphere SDFs, the VM NeRF's level grid)
    mt_entries = marching_phase(device, smi, args.parent)
    summary = {"card": smi, "dtu_export_s": dtu_export_s, "dtu_band_s": dtu_band_s,
               "dtu_band_launches": dtu_band_run, "colmap_export_s": colmap_export_s, **ds_runs,
               "jpeg": jpeg_run,
               "dp": {k: v for k, v in dp_run.items() if k != "runs"}
               | {"runs": {k: {f: x for f, x in r.items() if f != "records"}
                           for k, r in dp_run["runs"].items()}}}
    os.makedirs(os.path.join(ROOT, "exp", "chip_smoke_datasets"), exist_ok=True)
    with open(os.path.join(ROOT, "exp", "chip_smoke_datasets", "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1, default=str)
    # launches: counted in the run of the path that runs the kernel (the NeRF
    # training runs for K1/K2 and K13/K14, the NeuS training runs for
    # K3-K5/K9/K10, K11/K12 and K7/K8, the finite-difference run for K6),
    # with the per-step counts of each path
    paths = {"nerf_train": (step_launches, run_launches), "nerf_stacked_train": (st_step, st_run),
             "neus_train": (neus_step, neus_run), "neus_fd": (fd_step, fd_run),
             "neus_stacked_train": (ns_step, ns_run), "neus_raw_train": (nr_step, nr_run)}
    views = {"nerf_view": render_launches, "neus_view": neus_view, "neus_stacked_view": ns_view,
             "neus_raw_view": nr_view, **{f"neus_raw_{k}": v for k, v in nr_launches.items()}}
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
                     else "neus_raw_train" if name.startswith("cp_product_jac")
                     else "neus_fd" if name == "cp_product_backward" else "neus_train")
        e["launches"] = e[f"launches_{main_path}_run"]
        e["launches_path"] = main_path
        if e["launches"] < 1:
            raise AssertionError(f"{name}: not launched on its main path ({main_path})")
    # slice 6: HG1/HG2 on the hash NeRF's training run (and the launcher's
    # run of configs/nerf-synthetic.yaml), the cp_big instantiations on the
    # cp_big runs, the probes on the probe script's run (probe_phase)
    for e in hash_entries:
        name = e["name"]
        e["launches"] = hs_run[name]
        e["launches_path"] = "nerf_hash_train"
        e["launches_nerf_hash_train_step"] = hs_step[name]
        e["launches_launcher_train"] = launcher_train[name]
        e["launches_launcher_export"] = launcher_export[name]
    cp_big_path = {"cp_mlp": "nerf", "cp_jac_basis": "neus", "cp_product_jac": "neus_raw",
                   "cp_product": "neus_fd"}
    for e in cp_big_entries:
        kernel = e["name"].split("@")[0]
        path = next(v for k, v in cp_big_path.items() if kernel.startswith(k + "_"))
        e["launches"] = cp_big_counts[path][kernel]
        e["launches_path"] = f"cp_big_{path}_train"
    # slice 7: HG3/HG4 on the neus-synthetic launcher's training run (and its
    # export; HG1/HG2 also on the progressive-band run)
    for e in hash_jac_entries:
        name = e["name"]
        e["launches"] = nh_run[name]
        e["launches_path"] = "neus_hash_launcher_train"
        e["launches_neus_hash_launcher_train_step"] = nh_step[name]
        e["launches_neus_hash_launcher_export"] = nh_export[name]
    for e in hash_entries:
        e["launches_band_launcher_train"] = band_run[e["name"]]
    for e in hash_entries + hash_jac_entries + cp_big_entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']}: not launched on its main path "
                                 f"({e['launches_path']})")
    # slice 10: VM1 / VM2 on the VM NeRF's training run; MT1 / MT2 on its
    # mesh (the counts set to 0 just before it), and on every export of the run
    for e in vm_entries:
        e["launches"] = vm_run[e["name"]]
        e["launches_path"] = "nerf_vm_train"
        e["launches_nerf_vm_train_step"] = vm_step[e["name"]]
        e["device_ms_ray_ordered"] = STEP_DEVICE_MS.get(e["name"])
    step_x = STEP_OPERANDS["vm1"]["x"]
    fwd_step, bwd_step, distinct_step = vm_bounds(vm_spec(), step_x)
    for e, (ms, by) in zip(vm_entries, (fwd_step, bwd_step)):
        e.update(bound_ms_ray_ordered=ms, bound_by_ray_ordered=by,
                 distinct_rows_ray_ordered=distinct_step)
    for e in mt_entries:
        e["launches"] = VM_RUN["mesh_launches"][e["name"]]
        e["launches_path"] = "nerf_vm_mesh"
        for label, run in mt_runs.items():
            e[f"launches_{label}"] = run[e["name"]]
    for e in vm_entries + mt_entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']}: not launched on its main path "
                                 f"({e['launches_path']})")
    entries += hash_entries + hash_jac_entries + cp_big_entries + probe_entries
    entries += vm_entries + mt_entries
    # slice 8: HG1-HG4, K3 and K4 on the Blender and DTU launcher runs (the
    # NeRF's --export; HG1 / HG2 on neuralangelo-dtu-wmask.yaml's run)
    for e in entries:
        name = e["name"]
        for key, run in ds_runs.items():
            if name in run["launches"]:
                e[f"launches_{key}_train"] = run["launches"][name]
                e[f"launches_{key}_step"] = run["step"][name]
        for key in ("blender_nerf", "colmap_nerf"):
            if name in ds_runs[key]["export_launches"]:
                e[f"launches_{key}_export"] = ds_runs[key]["export_launches"][name]
        if name in dtu_band_run:
            e["launches_dtu_band_train"] = dtu_band_run[name]
        # slice 15: each rank's launches in the data-parallel runs (training,
        # val, test; MT1 / MT2 in rank 0's mesh)
        for key, run in dp_run["runs"].items():
            for r in run["records"]:
                if name in r["launches_run"]:
                    e[f"launches_{key}_rank{r['rank']}"] = r["launches_run"][name]
    # the redesigned kernels: ptxas' registers and spills, the launch plan
    # (shared memory, blocks per SM), the time on a training step's own
    # operands, and the parent design's times where a parent checkout is given
    # (for the forwards also on the same step's operands, saved for it)
    from instant_nsr_pl_tpu_torch.ops import cuda_build

    os.makedirs(os.path.dirname(STEP_OPERANDS_PATH), exist_ok=True)
    torch.save(STEP_OPERANDS, STEP_OPERANDS_PATH)
    parent, parent_dev = parent_times(args.parent) if args.parent else ({}, {})

    def plan_of(stem, marker, plan_key):
        plan = next((v for k, v in cuda_build.PLANS.items() if k[:-1] == plan_key), None)
        ptxas = ptxas_info(stem, marker)
        if plan_key is None and ptxas:  # 128-thread blocks, 2,048 threads, 228 KB shared
            smem = ptxas.get("static_smem_bytes", 0)
            plan = {"smem_bytes": smem,
                    "blocks_per_sm": min(16, 65536 // (-(-ptxas["registers"] // 8) * 8 * 128),
                                         233472 // (smem + 1024))}
        return ptxas, plan

    for e in entries:
        if e["name"] not in REDESIGNED_KERNELS:
            continue
        ptxas, plan = plan_of(*REDESIGNED_KERNELS[e["name"]])
        step = STEP_MS.get(e["name"])
        key = BENCH_KEY[e["name"]]
        e.update({
            "ptxas": ptxas,
            "smem_bytes": plan["smem_bytes"] if plan else None,
            "blocks_per_sm": plan["blocks_per_sm"] if plan else None,
            "ms_ray_ordered": step[0] if step else None,
            "n_ray_ordered": step[1] if step else None,
            "n_ray_ordered_launches": step[2] if step else None,
            "parent_ms": parent.get(f"{key}@uniform"),
            "parent_ms_ray": parent.get(f"{key}@ray"),
            "parent_device_ms": parent_dev.get(f"{key}@uniform"),
            "parent_device_ms_ray": parent_dev.get(f"{key}@ray"),
        })
        if e["name"] in EVAL_MARKERS:  # K1 / K13 / cp_big's K1: both modes
            ptxas_eval, plan_eval = plan_of(*EVAL_MARKERS[e["name"]])
            e.update({
                "ptxas_eval": ptxas_eval,
                "smem_bytes_eval": plan_eval["smem_bytes"] if plan_eval else None,
                "blocks_per_sm_eval": plan_eval["blocks_per_sm"] if plan_eval else None,
                "parent_ms_eval": parent.get(f"{key}_eval@uniform"),
            })
        if e["name"].endswith(("forward", "forward@cp_big")) or key.startswith(("k8", "k6", "hg2",
                                                                                 "hg4", "vm")):
            e["parent_ms_step"] = parent.get(f"{key}@step")
        if key.startswith("vm"):
            e["parent_device_ms_step"] = parent_dev.get(f"{key}@step")
        print(f"[design] {e['name']}: {e['ms']:.4f} ms uniform (device {e.get('device_ms')}), "
              f"step operands {e['ms_ray_ordered']}, parent {e['parent_ms']} / ray "
              f"{e['parent_ms_ray']} / step {e.get('parent_ms_step')}, ptxas {e['ptxas']}, "
              f"{e['smem_bytes']} B shared, {e['blocks_per_sm']} blocks per SM"
              + (f"; eval: ptxas {e['ptxas_eval']}, {e['smem_bytes_eval']} B, "
                 f"{e['blocks_per_sm_eval']} blocks per SM, parent {e['parent_ms_eval']}"
                 if "ptxas_eval" in e else "") + f" ({smi})", flush=True)
    print(f"[wall] {time.perf_counter() - t_start:.1f} s from the start to the result lines",
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
