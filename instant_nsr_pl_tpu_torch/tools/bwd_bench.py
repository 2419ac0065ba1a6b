"""Time the fused backward kernels K2 (``csrc/cp_mlp_bwd.cu``), its stacked
(K14) and ``cp_big`` instantiations, and K4 (``csrc/sh_mlp_bwd.cu``) on the
card, optionally from another checkout of the port and with phases cut out.

    python instant_nsr_pl_tpu_torch/tools/bwd_bench.py [--root DIR]
        [--cuts] [--order uniform,ray] [--out result.json]

``--root`` imports the port from checkout DIR (for example the parent
commit unpacked with ``git archive``) instead of this one: the script calls
only the public ops (``cp_mlp_operands``, ``cp_mlp_launch``,
``cp_mlp_backward_launch``, their stacked twins, ``pack_sh_mlp``,
``sh_mlp_launch``, ``sh_mlp_backward_launch``), whose signatures every
design keeps, so two designs are timed by the same code. Run it for the two
roots in turns within one call (a, b, b, a) to compare them on one card.

The operands are those of ``chip_smoke.py``'s kernel phases at N = 262,144:
the bench NeRF's density head (CP C=64, R=(128, 2048), F=16, MLP 32->64->16),
the stacked head (R=(129, 2049)), the ``cp_big`` head (C=128, R=(64, 512,
4096), MLP 48->64->16) and the radiance head (SH degree 4, 16 features, MLP
32->64->64->3), from seeded random weights; the residuals come from one
training-mode forward. ``--order uniform`` (the default) draws positions uniformly in
[-0.05, 1.05]^3; ``--order ray`` packs 512 rays of 512 evenly spaced samples
across the unit box each, as a bench training step packs its 262,144 slots
(its ~4.6 M live samples overflow them, so the buffer holds the first few
hundred rays' samples, whole and in order);
``--order uniform,ray`` times both.

``--cuts`` also times scratch variants: a copy of the root's ``csrc/`` with
one phase of a backward kernel edited out (the line-table atomics, the
whole line-table scatter, the d-basis reduction, the MLP tile reductions of
the CUDA-core design; the scatter loop, the d-basis products and the MLP
backward of the tensor-core design, or its scatter replaced by one without
the row merge),
all built at once with ``nvcc -Xptxas -v`` into a temporary directory. The edits
are text replacements on the copy; a variant whose text is not in the
root's source is reported as not applicable. The variants' outputs are
wrong by construction and are only timed.

Each case is timed two ways: back to back with CUDA events (``ms``, as
``chip_smoke.py`` times every kernel) and as device time under
torch.profiler (``device_ms``: the kernels and memsets of a call, by name).
Prints one line per timing, the ptxas lines (registers, shared memory,
spills) of each build, and one JSON object last; exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

N = 262144
SEED = 0

# phase cuts: variant -> (source stem, [(file, old text, new text), ...])
_ATOMIC_SINK = (
    "__device__ __forceinline__ void atomic_add4(float* dst, float a, float b, float c,\n"
    "                                            float d) {\n",
    "__device__ __forceinline__ void atomic_add4(float* dst, float a, float b, float c,\n"
    "                                            float d) {\n"
    "  if (a + b + c + d == 1.2345e-37f) *dst = a;  // keeps the values live\n"
    "  return;\n",
)
CUTS = {
    # the parent design (one 128-thread block per SM, CUDA-core reductions)
    "k2_no_line_atomics": ("cp_mlp_bwd", [("cp_common.cuh", *_ATOMIC_SINK)]),
    "k2_no_line_scatter": ("cp_mlp_bwd", [(
        "cp_mlp_bwd.cu",
        "    // line tables: scatter the two tent-weighted rows per scale and axis\n"
        "    if (active) {",
        "    // line tables: scatter the two tent-weighted rows per scale and axis\n"
        "    if (false) {")]),
    "k2_no_dbasis": ("cp_mlp_bwd", [(
        "cp_mlp_bwd.cu",
        "    // at a time\n#pragma unroll\n    for (int s = 0; s < S; ++s) {",
        "    // at a time\n    for (int s = 0; s < 0; ++s) {")]),
    "k2_no_mlp_reductions": ("cp_mlp_bwd", [("mlp_common.cuh", *(
        "    if (li == 0) {\n"
        "      reduce_tile<DIN, W, TS::LDA, TS::LDG>(a_s, g_s, dw_acc, db_acc);\n"
        "    } else {\n"
        "      reduce_tile<W, W, TS::LDA, TS::LDG>(a_s, g_s, dw_acc + row0 * W,\n"
        "                                          db_acc + li * W);\n"
        "    }\n", ""))]),
}
CUTS["k4_no_mlp_reductions"] = ("sh_mlp_bwd", CUTS["k2_no_mlp_reductions"][1])
# the tensor-core design (csrc/mma_common.cuh): the scatter loop, the d-basis
# products, the MLP backward (d_enc stays zero), K4's MLP backward, and the
# scatter replaced by a parallel one
CUTS.update({
    "k2_tc_no_line_scatter": ("cp_mlp_bwd", [(
        "cp_mlp_bwd.cu",
        "for (int u = grp; u < 3 * (kT / K::SEG); u += K::NG) {",
        "for (int u = grp; u < 0; u += K::NG) {")]),
    "k2_tc_no_dbasis": ("cp_mlp_bwd", [(
        "cp_mlp_bwd.cu",
        "for (int q = 0; q < (C / 16) * (F / 8); ++q) {",
        "for (int q = 0; q < 0; ++q) {")]),
    "k2_tc_no_mlp": ("cp_mlp_bwd", [(
        "cp_mlp_bwd.cu",
        "          mlp_backward_tile<S, K::E / 16>(",
        "          if (false) mlp_backward_tile<S, K::E / 16>(")]),
    # the alternative the scatter was measured against: every (axis, sample)
    # item in parallel, each adding its two rows, no merge
    "k2_tc_scatter_parallel": ("cp_mlp_bwd", [(
        "cp_mlp_bwd.cu",
        "        for (int u = grp; u < 3 * (kT / K::SEG); u += K::NG) {\n",
        "#pragma unroll 4\n"
        "        for (int it = grp; it < 3 * kT; it += K::NG) {\n"
        "          const int a = it / kT, t = it % kT;\n"
        "          if (t >= nv) continue;\n"
        "          const uint2 raw = *reinterpret_cast<const uint2*>(dvs + it * K::LDC + 4 * ql);\n"
        "          float* dst = dlines.ptr[s] + (static_cast<long long>(a) * res + ti0[it]) * LD"
        " + 4 * ql;\n"
        "          const float w0 = tw0[it], w1 = tw1[it];\n"
        "          const float d0 = bf16x2_lo(raw.x), d1 = bf16x2_hi(raw.x), d2 = bf16x2_lo(raw.y),"
        " d3 = bf16x2_hi(raw.y);\n"
        "          if (w0 != 0.0f) atomic_add4(dst, w0 * d0, w0 * d1, w0 * d2, w0 * d3);\n"
        "          if (w1 != 0.0f) atomic_add4(dst + LD, w1 * d0, w1 * d1, w1 * d2, w1 * d3);\n"
        "        }\n"
        "        for (int u = grp; u < 0; u += K::NG) {\n")]),
    "k4_tc_no_mlp": ("sh_mlp_bwd", [(
        "sh_mlp_bwd.cu",
        "    mlp_backward_tile<S, K::MT0>(",
        "    if (false) mlp_backward_tile<S, K::MT0>(")]),
})
# which timed case each source's variants run
CASES_OF = {"cp_mlp_bwd": ("k2", "k14", "k2_cp_big"), "sh_mlp_bwd": ("k4",)}


def time_ms(fn, reps=20, inner=10, warmup=3):
    """CUDA-event median over ``reps`` batches of ``inner`` calls, per call."""
    import torch

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


def device_ms(fn, calls=20):
    """Device time per call from torch.profiler: every CUDA kernel and memset
    a call launches (the backward kernel, its partial sum, the zeroed line
    tables), summed, and by name. Unlike ``time_ms`` it does not include
    the host's share when the host queues calls slower than the card runs
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    by_name = {k: v / calls / 1e3 for k, v in by_name.items()}
    return sum(by_name.values()), by_name


def positions(gen, order, n=N):
    """(n, 3) float32 positions: uniform, or n / 512 rays of 512 evenly
    spaced samples across the unit box (n a multiple of 512)."""
    import torch

    if order == "uniform":
        return torch.rand((n, 3), generator=gen) * 1.1 - 0.05
    n_rays, per_ray = n // 512, 512
    o = torch.nn.functional.normalize(torch.randn((n_rays, 3), generator=gen), dim=-1) * 1.5 + 0.5
    target = 0.3 + 0.4 * torch.rand((n_rays, 3), generator=gen)
    d = torch.nn.functional.normalize(target - o, dim=-1)
    t0 = (0.0 - o) / d
    t1 = (1.0 - o) / d
    near = torch.minimum(t0, t1).amax(-1, keepdim=True)
    far = torch.maximum(t0, t1).amin(-1, keepdim=True)
    t = near + (far - near) * ((torch.arange(per_ray, dtype=torch.float32) + 0.5) / per_ray)
    return (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()


def cases(device, order):
    """Per timed case: a zero-argument callable that launches the backward
    kernel once through its public wrapper, and a short description."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
    from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init

    out = {}

    def layers(gen, spec):
        return [{"w": l["w"].to(device),
                 "b": (0.1 * torch.randn(l["b"].shape, generator=gen)).to(device)}
                for l in mlp_init(gen, spec)]

    for key, (c, res, seed, stacked) in {
        "k2": (64, (128, 2048), SEED, False),
        "k14": (64, (129, 2049), SEED + 11, True),
        "k2_cp_big": (128, (64, 512, 4096), SEED + 17, False),
    }.items():
        gen = torch.Generator().manual_seed(seed)
        cp_spec = CPSpec(c, res, 16)
        d_spec = MLPSpec(dim_in=16 * len(res), dim_out=16, n_neurons=64, n_hidden_layers=1)
        cp_params = cp_init(gen, cp_spec, device)
        d_layers = layers(gen, d_spec)
        x = positions(gen, order).to(device)
        dout = torch.randn((N, 16), generator=gen).to(device)
        if stacked:
            ops = cp_mlp.cp_mlp_stacked_operands(cp_params, d_layers, cp_spec, d_spec)
            _, vsave, hsave = cp_mlp.cp_mlp_stacked_launch(ops, x, cp_spec, d_spec, train=True)
            launch = cp_mlp.cp_mlp_stacked_backward_launch
        else:
            ops = cp_mlp.cp_mlp_operands(cp_params, d_layers, cp_spec, d_spec)
            _, vsave, hsave = cp_mlp.cp_mlp_launch(ops, x, cp_spec, d_spec, train=True)
            launch = cp_mlp.cp_mlp_backward_launch
        args = (x, vsave, hsave, dout, ops[1], ops[2], cp_spec, d_spec)
        out[key] = (lambda launch=launch, args=args: launch(*args),
                    f"C={c}, R={res}, F=16, MLP {16 * len(res)}->64->16")

    gen = torch.Generator().manual_seed(SEED)
    r_spec = MLPSpec(dim_in=32, dim_out=3, n_neurons=64, n_hidden_layers=2,
                     output_activation="Sigmoid")
    r_layers = layers(gen, r_spec)
    feats = torch.randn((N, 16), generator=gen).to(device)
    x = positions(gen, order)
    if order == "uniform":
        dirs = torch.nn.functional.normalize(torch.randn((N, 3), generator=gen), dim=-1)
    else:  # one direction per ray of 512 samples
        rays = x.reshape(-1, 512, 3)
        dirs = torch.nn.functional.normalize(rays[:, -1] - rays[:, 0], dim=-1)
        dirs = dirs.repeat_interleave(512, dim=0)
    dirs = dirs.to(device)
    r_dout = torch.randn((N, 3), generator=gen).to(device)
    sh_ops = sh_mlp.pack_sh_mlp(r_layers, r_spec, 4, 16, 16)
    _, hsave = sh_mlp.sh_mlp_launch(sh_ops, feats, dirs, r_spec, 4, train=True)
    ws, _, fpad = sh_ops
    sh_args = (feats, dirs, hsave, r_dout, ws, fpad, r_spec, 4)
    out["k4"] = (lambda: sh_mlp.sh_mlp_backward_launch(*sh_args),
                 "SH 4, 16 features, MLP 32->64->64->3")
    return out


def _build(cuda_build, jobs):
    """nvcc each (name, source, library) of ``jobs`` with the port's flags, all
    at once; returns {name: its ptxas lines}."""
    procs = []
    for name, src, lib in jobs:
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(src.parent), "-o",
               str(lib), str(src)]
        procs.append((name, src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        out[name] = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "smem" in ln
                     or "Compiling entry" in ln]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--order", default="uniform",
                    help="uniform, ray, or both separated by a comma")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("bwd_bench: needs a CUDA card", file=sys.stderr)
        return 2
    from instant_nsr_pl_tpu_torch.ops import cuda_build

    if Path(cuda_build.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported the port from {cuda_build.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="bwd_bench_"))
    orders = args.order.split(",")
    result = {"root": str(root), "orders": orders, "n": N, "card": smi, "ms": {},
              "ptxas": {}, "cuts": {}}
    try:
        stems = ("cp_mlp_fwd", "cp_mlp_bwd", "sh_mlp_fwd", "sh_mlp_bwd")
        jobs = [(stem, cuda_build.CSRC / f"{stem}.cu", tmp / f"{stem}.so") for stem in stems]
        variants = {}
        for name, (stem, edits) in (CUTS.items() if args.cuts else ()):
            src_dir = tmp / name
            shutil.copytree(cuda_build.CSRC, src_dir)
            ok = True
            for fname, old, new in edits:
                path = src_dir / fname
                text = path.read_text()
                ok = ok and old in text
                path.write_text(text.replace(old, new, 1))
            if not ok:
                print(f"[cut] {name}: not applicable to this source", flush=True)
                result["cuts"][name] = None
                continue
            variants[name] = stem
            jobs.append((name, src_dir / f"{stem}.cu", tmp / f"{name}.so"))
        ptxas = _build(cuda_build, jobs)
        for stem in stems:
            result["ptxas"][stem] = ptxas[stem]
            cuda_build._LIBS[stem] = ctypes.CDLL(str(tmp / f"{stem}.so"))
        for name in ("cp_mlp_bwd", "sh_mlp_bwd", *variants):
            for line in ptxas[name]:
                print(f"[ptxas] {name}: {line}", flush=True)
        timed, loaded = {}, []
        for order in orders:
            for key, (fn, shape) in cases(device, order).items():
                key = f"{key}@{order}"
                timed[key] = fn
                fn()
                torch.cuda.synchronize()
                result["ms"][key] = time_ms(fn)
                dev, by_name = device_ms(fn)
                result.setdefault("device_ms", {})[key] = dev
                result.setdefault("device_kernels", {})[key] = by_name
                parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_name.items(),
                                                                    key=lambda kv: -kv[1]))
                print(f"[time] {key} ({shape}): {result['ms'][key]:.4f} ms back to back; device "
                      f"{dev:.4f} ms ({parts})  [{smi}]", flush=True)
        for name, stem in variants.items():
            saved = cuda_build._LIBS[stem]
            loaded.append(ctypes.CDLL(str(tmp / f"{name}.so")))  # kept alive: one id each
            cuda_build._LIBS[stem] = loaded[-1]
            cuda_build.PLANS.clear()  # a variant may fit more blocks per SM
            entry = {"ptxas": ptxas[name]}
            for key in [f"{k}@{o}" for k in CASES_OF[stem] for o in orders]:
                fn = timed[key]
                fn()
                torch.cuda.synchronize()
                entry[key] = time_ms(fn)
                entry[f"{key}:device"] = device_ms(fn)[0]
                print(f"[cut] {name} {key}: {entry[key]:.4f} ms, device "
                      f"{entry[f'{key}:device']:.4f} (full {result['ms'][key]:.4f}, device "
                      f"{result['device_ms'][key]:.4f})  [{smi}]", flush=True)
            cuda_build._LIBS[stem] = saved
            cuda_build.PLANS.clear()
            result["cuts"][name] = entry
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
