"""Time the backward kernels K2 (``csrc/cp_mlp_bwd.cu``), its stacked (K14)
and ``cp_big`` instantiations, K4 (``csrc/sh_mlp_bwd.cu``), K10
(``csrc/cp_jac_basis_bwd.cu``) with K12 and ``cp_big``'s K10, K8 (the raw
products' backward, the same source's no-basis instantiation) with
``cp_big``'s K8, K6 (the CP product's backward, its line-table
instantiation) with ``cp_big``'s K6, and HG2 (``csrc/hashgrid_bwd.cu``), and the forward kernels
K1 / K13 / ``cp_big``'s K1 (``csrc/cp_mlp_fwd.cu``, training and eval mode),
K3 (``csrc/sh_mlp_fwd.cu``, training and eval mode), K5 / ``cp_big``'s K5
(``csrc/cp_product_fwd.cu``), K9 / K11 / ``cp_big``'s K9
(``csrc/cp_jac_basis_fwd.cu``; all three in training and eval mode), HG1
(``csrc/hashgrid_fwd.cu``), HG3 / HG4 and VM1 / VM2 (``csrc/vm_{fwd,bwd}.cu``
at the VM NeRF's width: ``vm1``, ``vm2``, ``vm2_dx``) on the card,
optionally from another checkout of the port and with phases cut out.

    python instant_nsr_pl_tpu_torch/tools/bwd_bench.py [--root DIR]
        [--cuts] [--order uniform,ray] [--cases k10,hg2,...] [--merge-stats]
        [--step-operands FILE] [--out result.json]

``--root`` imports the port from checkout DIR (for example the parent
commit unpacked with ``git archive``) instead of this one: the script calls
only the public ops (``cp_mlp_operands``, ``cp_mlp_launch``,
``cp_mlp_backward_launch``, their stacked twins, ``pack_sh_mlp``,
``sh_mlp_launch``, ``sh_mlp_backward_launch``, the K5/K6, K7/K8, K9/K10 and
K11/K12 launches of ``ops/cp_product.py`` / ``ops/cp_stacked.py``,
``hashgrid_forward_launch``, ``hashgrid_backward_launch``), whose signatures
every design keeps, so two designs are timed by the same code. Each
checkout's hash table comes from its own ``hashgrid_init`` (feature-major
(F, T) before the table became row-major, (T, F) after; the same values).
``--step-operands FILE`` also times the forward kernels (K1, K13, K3, K5, K9,
K11, HG1, HG3, VM1), K8, K6, HG2, HG4 and VM2 on a training step's own operands as
``chip_smoke.py`` saved them
(``torch.save``: per case, the launch's arguments as plain tensors and
numbers), each case as ``<case>@step``; a (T, F) hash table is handed to a feature-major checkout
transposed. Run it for the two roots in turns within one call (a, b, b, a)
to compare them on one card.

The operands are those of ``chip_smoke.py``'s kernel phases at N = 262,144:
the bench NeRF's density head (CP C=64, R=(128, 2048), F=16, MLP 32->64->16),
the stacked head (R=(129, 2049)), the ``cp_big`` head (C=128, R=(64, 512,
4096), MLP 48->64->16) and the radiance head (SH degree 4, 16 features, MLP
32->64->64->3: K3, K4), the bench NeuS encoding for K9 and K10 (C=64, F=16,
R=128 and 2048: one launch each) and its raw products for K8 (C=64, R=128 and
2048), the stacked one for K11 and K12 (R=(129, 2049)), cp_big's for its K9,
K10 and K8 (C=128, R=64, 512, 4096), the CP product of the finite-difference
NeuS for K5 and K6 (C=64, R=128 and 2048; cp_big's C=128, R=64, 512, 4096)
and the bench hash grid for HG2 (16
levels, F=2, 2^19 rows), from seeded random weights; the residuals come from
one training-mode forward. ``--merge-stats`` counts, on each order's
positions, the row updates that a merge of equal rows would leave: HG2's per
level within a warp of 32 samples, K10's per axis within runs of 16 and 64,
VM2's per table kind as its merge window leaves them with runs of 8, 16 and
32 samples beside the distinct rows of each run (also on the VM NeRF step's
own positions, with ``--step-operands``). ``--order uniform`` (the default) draws positions uniformly in
[-0.05, 1.05]^3; ``--order ray`` packs 512 rays of 512 evenly spaced samples
across the unit box each, as a bench training step packs its 262,144 slots
(its ~4.6 M live samples overflow them, so the buffer holds the first few
hundred rays' samples, whole and in order); ``--order stencil`` expands
those ray-ordered points into the finite-difference NeuS's six-point stencil
(eps 1e-3 in the bench NeuS's world box of radius 1.5, clipped to the box, as
``models/geometry.py`` evaluates it: 6 x 262,144 points, a stencil launch's
size; K5 and K6 cases only); ``--order uniform,ray`` times both.

``--cuts`` also times scratch variants: a copy of the root's ``csrc/`` with
one phase of a backward kernel edited out (the line-table atomics, the
whole line-table scatter, the d-basis reduction, the MLP tile reductions of
the CUDA-core designs; the scatter loop, the d-basis products and the MLP
backward of the tensor-core designs, or K2's scatter replaced by one without
the row merge; HG2's atomics by level kind, its row merge, its (T, F)
vector atomics replaced by the (F, T) layout's scalar ones; K1's gather with
one step's loads in flight, its residuals written with plain stores or not
at all; HG1 with 1 or 2 levels a thread instead of 4; K8's scatter, or its
scatter without the merge of equal rows; K3 without the hsave write-out or
with plain stores for it; K6's scatter, its scatter without the row merge,
its atomics, or its table rows gathered past L1; HG2 without the merge of a
block's warps; K5 and K9 with one gather step's loads in flight, K5 also at
three blocks an SM, with plain stores or without its write-out, K9 without
its residual write-out or its tensor-core products; VM2 of the first
design without its plane, line or all atomics or its d x products, and of
the merge-window design without its plane or line scatter or both, without
the merge, with runs of 8 or 32 samples or without its d x terms; VM1 with
one pass's loads in flight or warps of 64 samples),
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
# K10 / K12 / cp_big K10 (csrc/cp_jac_basis_bwd.cu) and HG2 (csrc/hashgrid_bwd.cu)
# of the thread-per-sample designs: the line-table atomics, the whole scatter,
# the d-basis tile reduction, the dP / dJ loops; HG2's atomics of the dense
# levels, of the hashed levels, or all of them (each value stays live through a
# store that never happens)
_HG2_ATOMIC = ("        for (int f = 0; f < F; ++f) atomicAdd(dtable + f * total + t.row[c], "
               "t.w[c] * g[f]);\n")


def _hg2_cut(keep):
    return ("hashgrid_bwd", [("hashgrid_bwd.cu", _HG2_ATOMIC,
                              "        for (int f = 0; f < F; ++f) {\n"
                              "          const float v_ = t.w[c] * g[f];\n"
                              f"          if ({keep}) atomicAdd(dtable + f * total + t.row[c], v_);\n"
                              "          else if (v_ == 1.2345e-37f) dtable[t.row[c]] = v_;\n"
                              "        }\n")])


CUTS.update({
    "k10_no_line_atomics": ("cp_jac_basis_bwd", [("cp_common.cuh", *_ATOMIC_SINK)]),
    "k10_no_scatter": ("cp_jac_basis_bwd", [(
        "cp_jac_basis_bwd.cu",
        "          if (active) {\n#pragma unroll\n            for (int a = 0; a < 3; ++a) {\n"
        "              float* dst = drow0[a] + 4 * c4;",
        "          if (false) {\n#pragma unroll\n            for (int a = 0; a < 3; ++a) {\n"
        "              float* dst = drow0[a] + 4 * c4;")]),
    "k10_no_dbasis": ("cp_jac_basis_bwd", [(
        "cp_jac_basis_bwd.cu",
        "        reduce_tile<L::CT, F, L::LDA, L::LDG, L::ROWS>(a_s, g_s, acc + (s * C + c0) * F,\n"
        "                                                       nullptr);\n", "")]),
    "k10_no_dp_dj": ("cp_jac_basis_bwd", [(
        "cp_jac_basis_bwd.cu",
        "            for (int f4 = 0; f4 < F / 4; ++f4) {",
        "            for (int f4 = 0; f4 < 0; ++f4) {")]),
    # the tensor-core K10 design: the scatter walk, the d B products, the
    # [dP | dJ] products (their fragments stay zero)
    "k10_tc_no_scatter": ("cp_jac_basis_bwd", [(
        "cp_jac_basis_bwd.cu",
        "for (int q = grp * K::RUN; q < (grp + 1) * K::RUN; ++q) {",
        "for (int q = 0; q < 0; ++q) {")]),
    "k10_tc_no_dbasis": ("cp_jac_basis_bwd", [(
        "cp_jac_basis_bwd.cu",
        "for (int q = 0; q < K::FPS; ++q) {", "for (int q = 0; q < 0; ++q) {")]),
    "k10_tc_no_dp_dj": ("cp_jac_basis_bwd", [(
        "cp_jac_basis_bwd.cu", "            mma_bf16(dq[q], af, bq[q]);\n", "")]),
    # the merged-scatter HG2 (its merges of equal rows and its atomics live in
    # csrc/hashgrid_common.cuh, which HG4 shares): no merge within a warp;
    # the (F, T) layout's two 4-byte atomics per corner in place of one
    # 8-byte atomic (bench shape: T = 6,299,960); no atomics
    "hg2_new_no_merge": ("hashgrid_bwd", [(
        "hashgrid_common.cuh", "  const bool head = lane == 0 || left != row;",
        "  const bool head = true;")]),
    "hg2_new_ft_atomics": ("hashgrid_bwd", [(
        "hashgrid_common.cuh",
        "    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));",
        "    atomicAdd(dtable + row, v[0]);\n    atomicAdd(dtable + 6299960LL + row, v[1]);")]),
    "hg2_new_no_atomics": ("hashgrid_bwd", [(
        "hashgrid_common.cuh",
        "  float* p = dtable + static_cast<long long>(row) * F;\n",
        "  float* p = dtable + static_cast<long long>(row) * F;\n"
        "  if (v[0] == 1.2345e-37f) *p = v[0];  // keeps the value live\n  return;\n")]),
    "hg2_no_dense_atomics": _hg2_cut("lv.hashed"),
    "hg2_no_hashed_atomics": _hg2_cut("!lv.hashed"),
    "hg2_no_atomics": _hg2_cut("false"),
})
# the forward K1 / K13 / cp_big's K1 (csrc/cp_mlp_fwd.cu): one gather step's
# loads in flight instead of two (fewer registers), plain stores for the
# residuals instead of streaming ones, and no residual write-out at all
CUTS.update({
    "k1_group1": ("cp_mlp_fwd", [(
        "cp_mlp_fwd.cu", "static constexpr int GROUP = STEPS < 2 ? STEPS : 2;",
        "static constexpr int GROUP = 1;")]),
    "k1_plain_stores": ("cp_mlp_fwd", [(
        "mma_common.cuh",
        "        __stcs(reinterpret_cast<uint4*>(dst + static_cast<long long>(row_of(r)) * n + s0 + ch * 8),\n"
        "               v);",
        "        *reinterpret_cast<uint4*>(dst + static_cast<long long>(row_of(r)) * n + s0 + ch * 8) =\n"
        "            v;")]),
    "k1_no_residual_stores": ("cp_mlp_fwd", [(
        "mma_common.cuh",
        "  if ((n & 7) == 0) {\n    for (int q = threadIdx.x; q < rows * (kT / 8);",
        "  if ((n & 7) == 0) {\n    for (int q = threadIdx.x; q < 0;")]),
})
# HG1 (csrc/hashgrid_fwd.cu) with 1 or 2 levels a thread instead of 4
_HG1_GROUP = "  const int group = n_levels % 4 == 0 ? 4 : n_levels % 2 == 0 ? 2 : 1;"
CUTS.update({
    "hg1_levels1": ("hashgrid_fwd", [("hashgrid_fwd.cu", _HG1_GROUP, "  const int group = 1;")]),
    "hg1_levels2": ("hashgrid_fwd", [("hashgrid_fwd.cu", _HG1_GROUP,
                                      "  const int group = n_levels % 2 == 0 ? 2 : 1;")]),
})
# K8 (csrc/cp_jac_basis_bwd.cu, the no-basis instantiation): its scatter walk,
# and the walk without the window that merges equal rows (every sample adds
# its two rows per axis); K3 (csrc/sh_mlp_fwd.cu): no hsave write-out, or
# plain stores for it
_WINDOW = "          if (i0 != row) {\n            if (i0 == row + 1) {"
CUTS.update({
    "k8_no_scatter": ("cp_jac_basis_bwd", CUTS["k10_tc_no_scatter"][1]),
    "k8_no_row_merge": ("cp_jac_basis_bwd", [
        ("cp_jac_basis_bwd.cu", _WINDOW, "          if (true) {\n            if (false) {"),
        ("cp_jac_basis_bwd.cu", "} else if (i0 == row - 1) {", "} else if (false) {")]),
    "k3_no_hsave_stores": ("sh_mlp_fwd", [(
        "sh_mlp_fwd.cu",
        "      store_tile_rows(hb, hsave, n, s0, nv, NH * W, [](int row) { return row; });\n",
        "")]),
    "k3_plain_stores": ("sh_mlp_fwd", CUTS["k1_plain_stores"][1]),
})
# K6 (csrc/cp_jac_basis_bwd.cu, the line-table instantiation): its scatter
# walk, the walk without the row merge, its atomics, and the table rows
# gathered with cp.async.cg (L2 only) instead of .ca; HG2 without the merge of
# a block's warps' edge runs (every run's last lane adds its own atomic)
CUTS.update({
    "k6_no_scatter": ("cp_jac_basis_bwd", CUTS["k10_tc_no_scatter"][1]),
    "k6_no_row_merge": ("cp_jac_basis_bwd", CUTS["k8_no_row_merge"][1]),
    "k6_no_atomics": ("cp_jac_basis_bwd", [("cp_common.cuh", *_ATOMIC_SINK)]),
    "k6_gather_l2": ("cp_jac_basis_bwd", [(
        "cp_jac_basis_bwd.cu",
        "cp_async16_ca(gt + item * K::LDD + ch * 8, gdsrc + row * C + c0 + ch * 8);",
        "cp_async16(gt + item * K::LDD + ch * 8, gdsrc + row * C + c0 + ch * 8, 16);")]),
    "hg2_no_block_merge": ("hashgrid_bwd", [
        ("hashgrid_common.cuh", "  if (lane == first_end || lane == 31) {", "  if (false) {"),
        ("hashgrid_common.cuh", "  if (threadIdx.x >= 8) return;", "  return;")]),
})
# K5 / K9 (csrc/cp_product_fwd.cu, csrc/cp_jac_basis_fwd.cu, the tile designs):
# one gather step's loads in flight instead of two (for K5 also with three
# blocks an SM, at most 85 registers); K5's write-out (prod and vsave) with
# plain stores or not at all; K9's residual write-out left out,
# and its tensor-core products (enc and jac stay zero)
_INFLIGHT = "static constexpr int INFLIGHT = STEPS < 2 || PASSES > 1 ? 1 : 2;"
CUTS.update({
    "k5_one_step_in_flight": ("cp_product_fwd", [("cp_product_fwd.cu", _INFLIGHT,
                                                  "static constexpr int INFLIGHT = 1;")]),
    "k5_plain_stores": ("cp_product_fwd", [
        ("cp_product_fwd.cu", "        __stcs(reinterpret_cast<float4*>(",
         "        (*reinterpret_cast<float4*>("),
        ("cp_product_fwd.cu", "                                         ch * 4),\n               v);",
         "                                         ch * 4)) = v;"),
        *CUTS["k1_plain_stores"][1]]),
    "k5_no_stores": ("cp_product_fwd", [
        ("cp_product_fwd.cu", "    for (int q = threadIdx.x; q < rows * (kT / 4); q += kThreads) {",
         "    for (int q = threadIdx.x; q < 0; q += kThreads) {"),
        *CUTS["k1_no_residual_stores"][1]]),
    "k5_three_blocks": ("cp_product_fwd", [
        ("cp_product_fwd.cu", _INFLIGHT, "static constexpr int INFLIGHT = 1;"),
        ("cp_product_fwd.cu", "__global__ void __launch_bounds__(kThreads, 2)",
         "__global__ void __launch_bounds__(kThreads, 3)")]),
    "k9_one_step_in_flight": ("cp_jac_basis_fwd", [("cp_jac_basis_fwd.cu", _INFLIGHT,
                                                    "static constexpr int INFLIGHT = 1;")]),
    "k9_no_residual_stores": ("cp_jac_basis_fwd", CUTS["k1_no_residual_stores"][1]),
    "k9_no_projection": ("cp_jac_basis_fwd", [("cp_jac_basis_fwd.cu",
                                               "            mma_bf16(acc[q], af, bf);\n", "")]),
})
# HG4 (csrc/hashgrid_jac_bwd.cu) of the sample-major design (HG2's scatter
# walk, instantiated with the Jacobian cotangent; these texts are that
# design's, so they apply with --root at a checkout of it): no atomics, no merge of
# equal rows within a warp, no merge across the block's warps, and the
# level-major grid (N/128 blocks x the levels, one level a block, atomics and
# merges kept). The edits go to the copy's hashgrid_common.cuh, which only
# this variant's HG4 is built from (_SAMPLE_MAJOR_HG4, a text of that design
# only, keeps a cut from applying to another).
_SAMPLE_MAJOR_MERGE = [("hashgrid_common.cuh", "        if (lane == first_end || lane == 31) {",
                        "        if (false) {"),
                       ("hashgrid_common.cuh", "      if (threadIdx.x < 8) {", "      if (false) {")]
_SAMPLE_MAJOR_HG4 = ("hashgrid_jac_bwd.cu", "JacCotangent<F>{ct_f, ct_j, n}",
                     "JacCotangent<F>{ct_f, ct_j, n}")
CUTS.update({
    "hg4_no_atomics": ("hashgrid_jac_bwd", [*CUTS["hg2_new_no_atomics"][1], _SAMPLE_MAJOR_HG4]),
    "hg4_no_merge": ("hashgrid_jac_bwd", [(
        "hashgrid_common.cuh", "        const bool head = lane == 0 || left != row;",
        "        const bool head = true;")]),
    "hg4_no_block_merge": ("hashgrid_jac_bwd", _SAMPLE_MAJOR_MERGE),
    "hg4_level_major": ("hashgrid_jac_bwd", [
        ("hashgrid_common.cuh", "    for (int l = 0; l < n_levels; ++l, buf ^= 1) {",
         "    for (int l = blockIdx.y; l < static_cast<int>(blockIdx.y) + 1; ++l, buf ^= 1) {"),
        ("hashgrid_jac_bwd.cu",
         "hashgrid_jac_bwd_kernel<F><<<hash_grid_for(n), kHashBlock, 0, stream>>>(",
         "hashgrid_jac_bwd_kernel<F><<<dim3(static_cast<unsigned>((n + kHashBlock - 1) / "
         "kHashBlock), n_levels), kHashBlock, 0, stream>>>(")]),
})
# HG4 of the tiled design (tiles of 128 samples x 1 level, one wave of
# blocks): 4 levels a tile, or every level (the sample-major schedule);
# tiles ordered by level first (the card on one level at a time); no pair
# atomics of x-neighbour rows; no skip of a warp whose cotangents are zero;
# no merge across the block's warps; no atomics
_TILE_LEVELS = "constexpr int kTileLevels = 1;"
CUTS.update({
    "hg4_tile_levels4": ("hashgrid_jac_bwd", [("hashgrid_jac_bwd.cu", _TILE_LEVELS,
                                               "constexpr int kTileLevels = 4;")]),
    "hg4_tile_levels_all": ("hashgrid_jac_bwd", [("hashgrid_jac_bwd.cu", _TILE_LEVELS,
                                                  "constexpr int kTileLevels = kHashMaxLevels;")]),
    "hg4_group_major": ("hashgrid_jac_bwd", [(
        "hashgrid_jac_bwd.cu",
        "    const long long i = t / groups * kHashBlock + threadIdx.x;\n"
        "    const int l0 = static_cast<int>(t % groups) * kTileLevels;",
        "    const long long i = t % blocks * kHashBlock + threadIdx.x;\n"
        "    const int l0 = static_cast<int>(t / blocks) * kTileLevels;")]),
    "hg4_no_pair": ("hashgrid_jac_bwd", [(
        "hashgrid_jac_bwd.cu", "    if (add0 && add1 && (row0 ^ row1) == 1u) {",
        "    if (false) {")]),
    "hg4_no_zero_warp_skip": ("hashgrid_jac_bwd", [(
        "hashgrid_jac_bwd.cu", "      if (__all_sync(0xffffffffu, !nonzero(gf)",
        "      if (false && __all_sync(0xffffffffu, !nonzero(gf)")]),
    "hg4_tiled_no_block_merge": ("hashgrid_jac_bwd", CUTS["hg2_no_block_merge"][1]),
    "hg4_tiled_no_atomics": ("hashgrid_jac_bwd", [
        *CUTS["hg2_new_no_atomics"][1],
        ("hashgrid_jac_bwd.cu", "  float* p = dtable + static_cast<long long>(row) * F;\n",
         "  float* p = dtable + static_cast<long long>(row) * F;\n"
         "  if (lo[0] == 1.2345e-37f) *p = hi[0];  // keeps the values live\n  return;\n")]),
})
# HG3 (csrc/hashgrid_jac_fwd.cu) of the own-slice design at 1 or 2 levels a
# thread instead of 4, and without its Jacobian stores (the Jacobian still
# summed: a store that never happens keeps it live); of the staged design:
# 2 levels a thread, 10 or 12 blocks an SM (48 or 40 registers) instead of
# 8 (64), each lane storing its own sample's slice (half a sector an
# instruction) instead of the pieces of whole sectors, plain stores instead
# of streaming ones, and feat alone written out (the Jacobian staged but not
# stored)
_JAC_FWD_OUT = ("        __stcs(reinterpret_cast<float4*>(d), "
                "*reinterpret_cast<const float4*>(src));")
_JAC_FWD_BLOCKS = "constexpr int kJacFwdBlocks = 8;"
CUTS.update({
    "hg3_levels1": ("hashgrid_jac_fwd", [("hashgrid_jac_fwd.cu", _HG1_GROUP,
                                          "  const int group = 1;")]),
    "hg3_levels2": ("hashgrid_jac_fwd", [("hashgrid_jac_fwd.cu", _HG1_GROUP,
                                          "  const int group = n_levels % 2 == 0 ? 2 : 1;")]),
    "hg3_no_jac_stores": ("hashgrid_jac_fwd", [(
        "hashgrid_jac_fwd.cu",
        "  for (int d = 0; d < 3; ++d) store_vec<LG * F>(jac + d * n * n_levels * F + row, jres[d]);",
        "  for (int d = 0; d < 3; ++d) {\n"
        "    float s_ = 0.0f;\n"
        "    for (int k = 0; k < LG * F; ++k) s_ += jres[d][k];\n"
        "    if (s_ == 1.2345e-37f) jac[row] = s_;  // keeps the Jacobian live\n"
        "  }")]),
    "hg3_staged_levels2": ("hashgrid_jac_fwd", [(
        "hashgrid_jac_fwd.cu", "  int group = n_levels % 4 == 0 ? 4 : n_levels % 2 == 0 ? 2 : 1;",
        "  int group = n_levels % 2 == 0 ? 2 : 1;")]),
    "hg3_blocks10": ("hashgrid_jac_fwd", [("hashgrid_jac_fwd.cu", _JAC_FWD_BLOCKS,
                                           "constexpr int kJacFwdBlocks = 10;")]),
    "hg3_blocks12": ("hashgrid_jac_fwd", [("hashgrid_jac_fwd.cu", _JAC_FWD_BLOCKS,
                                           "constexpr int kJacFwdBlocks = 12;")]),
    "hg3_own_slice_stores": ("hashgrid_jac_fwd", [(
        "hashgrid_jac_fwd.cu", "      const int smp = e / P, pc = e % P;",
        "      const int smp = e % 32, pc = e / 32;")]),
    "hg3_plain_stores": ("hashgrid_jac_fwd", [(
        "hashgrid_jac_fwd.cu", _JAC_FWD_OUT,
        "        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src);")]),
    "hg3_staged_no_jac_stores": ("hashgrid_jac_fwd", [(
        "hashgrid_jac_fwd.cu", "  for (int k = 0; k < kJacOutputs; ++k) {",
        "  for (int k = 0; k < 1; ++k) {")]),
})
# VM2 (csrc/vm_bwd.cu) of the first design (a thread per sample and plane,
# C / 4 float4 atomics per row): without the plane atomics, the line atomics
# or any (the updates still formed: a store that never happens keeps them
# live), and without the products of d x (with d x asked for)
_VM_SINK = ("__device__ __forceinline__ float dot4(",
            "__device__ __forceinline__ void sink4(float* p, float4 v) {\n"
            "  if (v.x + v.y + v.z + v.w == 1.2345e-37f) *p = v.x;  // keeps the values live\n"
            "}\n\n__device__ __forceinline__ float dot4(")
_VM_PLANE_ATOMICS = (
    "        atomic_add4(dplane + static_cast<long long>(t.prow[k]) * C + q, scale4(gl, t.pw[k]));",
    "        sink4(dplane + static_cast<long long>(t.prow[k]) * C + q, scale4(gl, t.pw[k]));")
_VM_LINE_ATOMICS = (
    "      atomic_add4(dline + static_cast<long long>(t.lrow0) * C + q, scale4(gp, t.lw[0]));\n"
    "      atomic_add4(dline + static_cast<long long>(t.lrow0 + 1) * C + q, scale4(gp, t.lw[1]));",
    "      sink4(dline + static_cast<long long>(t.lrow0) * C + q, scale4(gp, t.lw[0]));\n"
    "      sink4(dline + static_cast<long long>(t.lrow0 + 1) * C + q, scale4(gp, t.lw[1]));")
CUTS.update({
    "vm2_first_no_plane_atomics": ("vm_bwd", [("vm_bwd.cu", *_VM_SINK),
                                              ("vm_bwd.cu", *_VM_PLANE_ATOMICS)]),
    "vm2_first_no_line_atomics": ("vm_bwd", [("vm_bwd.cu", *_VM_SINK),
                                             ("vm_bwd.cu", *_VM_LINE_ATOMICS)]),
    "vm2_first_no_atomics": ("vm_bwd", [("vm_bwd.cu", *_VM_SINK), ("vm_bwd.cu", *_VM_PLANE_ATOMICS),
                                        ("vm_bwd.cu", *_VM_LINE_ATOMICS)]),
    "vm2_first_no_dx": ("vm_bwd", [(
        "vm_bwd.cu", "      if (dx != nullptr) {\n#pragma unroll\n        for (int k = 0; k < 4; ++k) gp_tap",
        "      if (false) {\n#pragma unroll\n        for (int k = 0; k < 4; ++k) gp_tap")]),
})
# VM2 of the merge-window design: without the plane or the line scatter
# (window and atomics; the updates kept live) or both, without the merge
# (every tap's update added at once), with runs of 8 or 32 samples, at 5 or
# 6 blocks an SM (at most 102 or 85 registers instead of 127), and without
# the d x terms (with d x asked for); VM1 with one pass's loads in
# flight instead of two, and with warps of 64 samples
_VM_WINDOW_SINK = (
    "// The end of a run: every row still in the window is added.",
    "template <int T>\n"
    "__device__ __forceinline__ void sink_window(const float4 (&upd)[T], float* p) {\n"
    "  float s = 0.0f;\n"
    "  for (int k = 0; k < T; ++k) s += upd[k].x + upd[k].y + upd[k].z + upd[k].w;\n"
    "  if (s == 1.2345e-37f) *p = s;  // keeps the values live\n"
    "}\n\n// The end of a run: every row still in the window is added.")
_VM_PLANE_WINDOW = [("vm_bwd.cu", "    merge_window<4>(prows, pupd, pprev, pacc, dplane, C, q);",
                     "    sink_window<4>(pupd, dplane);"),
                    ("vm_bwd.cu", "  flush_window<4>(pprev, pacc, dplane, C, q);", "")]
_VM_LINE_WINDOW = [("vm_bwd.cu", "    merge_window<2>(lrows, lupd, lprev, lacc, dline, C, q);",
                    "    sink_window<2>(lupd, dline);"),
                   ("vm_bwd.cu", "  flush_window<2>(lprev, lacc, dline, C, q);", "")]
_VM_RUN = "constexpr int kVMRun = 16;"
CUTS.update({
    "vm2_no_plane_scatter": ("vm_bwd", [("vm_bwd.cu", *_VM_WINDOW_SINK), *_VM_PLANE_WINDOW]),
    "vm2_no_line_scatter": ("vm_bwd", [("vm_bwd.cu", *_VM_WINDOW_SINK), *_VM_LINE_WINDOW]),
    "vm2_no_scatter": ("vm_bwd", [("vm_bwd.cu", *_VM_WINDOW_SINK), *_VM_PLANE_WINDOW,
                                  *_VM_LINE_WINDOW]),
    "vm2_no_merge": ("vm_bwd", [("vm_bwd.cu", "      if (rows[k] == prev[m]) {",
                                 "      if (false) {")]),
    "vm2_run8": ("vm_bwd", [("vm_bwd.cu", _VM_RUN, "constexpr int kVMRun = 8;")]),
    "vm2_run32": ("vm_bwd", [("vm_bwd.cu", _VM_RUN, "constexpr int kVMRun = 32;")]),
    "vm2_no_dx": ("vm_bwd", [("vm_bwd.cu", "    if constexpr (DX) {\n      float gp_tap",
                              "    if constexpr (false) {\n      float gp_tap")]),
    "vm2_blocks5": ("vm_bwd", [("vm_bwd.cu", "__launch_bounds__(kVMBlock)\n    vm_bwd_kernel",
                                "__launch_bounds__(kVMBlock, 5)\n    vm_bwd_kernel")]),
    "vm2_blocks6": ("vm_bwd", [("vm_bwd.cu", "__launch_bounds__(kVMBlock)\n    vm_bwd_kernel",
                                "__launch_bounds__(kVMBlock, 6)\n    vm_bwd_kernel")]),
    "vm1_one_pass_in_flight": ("vm_fwd", [("vm_fwd.cu", "#pragma unroll 2\n", "#pragma unroll 1\n")]),
    "vm1_samples64": ("vm_fwd", [("vm_fwd.cu", "constexpr int kVMFwdSamples = 32;",
                                  "constexpr int kVMFwdSamples = 64;")]),
})
# which timed case each source's variants run (the parent design's K8 and K6
# have sources of their own, csrc/cp_product_jac_bwd.cu and
# csrc/cp_product_bwd.cu; a stem a checkout does not have is left out)
CASES_OF = {"cp_mlp_bwd": ("k2", "k14", "k2_cp_big"), "sh_mlp_bwd": ("k4",),
            "cp_jac_basis_bwd": ("k10", "k12", "k10_cp_big", "k8", "k8_cp_big", "k6",
                                 "k6_cp_big"),
            "cp_product_jac_bwd": ("k8", "k8_cp_big"),
            "cp_product_bwd": ("k6", "k6_cp_big"),
            "hashgrid_bwd": ("hg2", "hg2_dx"),
            "cp_mlp_fwd": ("k1", "k1_eval", "k13", "k13_eval", "k1_cp_big", "k1_cp_big_eval"),
            "cp_product_fwd": ("k5", "k5_eval", "k5_cp_big", "k5_cp_big_eval"),
            "cp_jac_basis_fwd": ("k9", "k9_eval", "k11", "k11_eval", "k9_cp_big",
                                 "k9_cp_big_eval"),
            "sh_mlp_fwd": ("k3", "k3_eval"),
            "hashgrid_fwd": ("hg1", "hg1_chunked", "ft_to_tf"),
            "hashgrid_jac_fwd": ("hg3", "hg3_eval"),
            "hashgrid_jac_bwd": ("hg4", "hg4_dx", "hg4_262k"),
            "vm_fwd": ("vm1",), "vm_bwd": ("vm2", "vm2_dx")}
# a variant's cases where they are not all of its source's
CUT_CASES = {**{name: ("k10", "k12", "k10_cp_big") for name in CUTS if name.startswith("k10_tc")},
             "k8_no_scatter": ("k8", "k8_cp_big"), "k8_no_row_merge": ("k8", "k8_cp_big"),
             **{name: ("k6", "k6_cp_big") for name in CUTS if name.startswith("k6_")},
             "k3_no_hsave_stores": ("k3",), "k3_plain_stores": ("k3",),
             "k9_no_residual_stores": ("k9", "k11", "k9_cp_big"),
             "vm2_first_no_dx": ("vm2_dx",), "vm2_no_dx": ("vm2_dx",)}
# the sources a case's operands also need (a backward's residuals come from
# its forward)
PARTNER = {"cp_mlp_bwd": ("cp_mlp_fwd",), "sh_mlp_bwd": ("sh_mlp_fwd",),
           "cp_jac_basis_bwd": ("cp_jac_basis_fwd", "cp_product_jac_fwd", "cp_product_fwd"),
           "cp_product_jac_bwd": ("cp_product_jac_fwd",),
           "cp_product_bwd": ("cp_product_fwd",),
           "hashgrid_bwd": ("hashgrid_fwd",), "cp_mlp_fwd": ("cp_mlp_bwd",),
           "sh_mlp_fwd": (), "hashgrid_fwd": ("hashgrid_bwd",), "cp_product_fwd": (),
           "cp_jac_basis_fwd": (), "hashgrid_jac_fwd": ("hashgrid_jac_bwd", "hashgrid_fwd"),
           "hashgrid_jac_bwd": ("hashgrid_jac_fwd",), "vm_fwd": (), "vm_bwd": ()}
FWD_CASES = {*CASES_OF["cp_mlp_fwd"], *CASES_OF["sh_mlp_fwd"]}
STENCIL_CASES = {"k6", "k6_cp_big", *CASES_OF["cp_product_fwd"]}


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


STENCIL_RADIUS = 1.5  # the bench NeuS's world box (neus-cp-synthetic.yaml model.radius)
STENCIL_EPS = 1e-3  # its geometry's finite_difference_eps


def stencil(u):
    """The finite-difference NeuS's six-point stencil around unit-box
    positions u (n, 3), as ``models/geometry.py`` builds it: in the world box
    of radius STENCIL_RADIUS, x +- eps along each axis clipped to the box,
    mapped back to the unit box. (6 n, 3), a sample's six points in a row."""
    import torch

    from instant_nsr_pl_tpu_torch.ops.contraction import (ContractionType,
                                                          contract_to_unisphere,
                                                          uncontract_from_unisphere)

    r = torch.tensor(STENCIL_RADIUS, dtype=torch.float32)
    offsets = torch.tensor(((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)),
                           dtype=torch.float32)
    x = uncontract_from_unisphere(u, STENCIL_RADIUS, ContractionType.AABB)
    pts = torch.minimum(torch.maximum(x[:, None, :] + torch.tensor(STENCIL_EPS) * offsets, -r), r)
    return contract_to_unisphere(pts.reshape(-1, 3), STENCIL_RADIUS,
                                 ContractionType.AABB).contiguous()


# the per-sample position step in [0, 1] coordinates of configs/nerf-blender.yaml
# and neus-blender.yaml (radius 1.5, 1024 samples a ray): render_step_size / 2r
BLENDER_DEDUP_STEP = 1.732 * 2.0 * 1.5 / 1024 / (2.0 * 1.5)


def march_blocks(gen, n=N, step=BLENDER_DEDUP_STEP, per_ray=512):
    """(n, 3) float32 positions as the group-compacted march packs them: rays
    of ``per_ray`` samples (n a multiple of it) at uniform steps of ``step``
    from a random start in [0.02, 0.98]^3, clipped to the unit box, so every
    aligned block of up to ``per_ray`` samples is one ray's uniform run (the
    tap dedup's premise)."""
    import torch

    n_rays = n // per_ray
    x0 = torch.rand((n_rays, 3), generator=gen) * 0.96 + 0.02
    d = torch.nn.functional.normalize(torch.randn((n_rays, 3), generator=gen), dim=-1)
    i = torch.arange(per_ray, dtype=torch.float32)[None, :, None]
    x = (x0[:, None, :] + d[:, None, :] * (i * step)).clamp(0.0, 1.0)
    return x.reshape(-1, 3).contiguous()


def positions(gen, order, n=N):
    """(n, 3) float32 positions: uniform, or n / 512 rays of 512 evenly
    spaced samples across the unit box (n a multiple of 512), or ("stencil")
    those rays' samples expanded into the six-point stencil, (6 n, 3)."""
    import torch

    if order == "uniform":
        return torch.rand((n, 3), generator=gen) * 1.1 - 0.05
    if order == "stencil":
        return stencil(positions(gen, "ray", n))
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


def cases(device, order, wanted=None):
    """Per timed case (all, or those in ``wanted``): a zero-argument callable
    that launches the backward kernel once through its public wrapper, and a
    short description."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
    from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init

    out = {}
    if wanted is not None and not wanted & ({"k2", "k14", "k2_cp_big", "k4"} | FWD_CASES):
        return {**jac_cases(device, order, wanted), **hash_cases(device, order, wanted),
                **hash_jac_cases(device, order, wanted), **vm_cases(device, order, wanted)}

    def layers(gen, spec):
        return [{"w": l["w"].to(device),
                 "b": (0.1 * torch.randn(l["b"].shape, generator=gen)).to(device)}
                for l in mlp_init(gen, spec)]

    for key, (c, res, seed, stacked, fwd_key) in {
        "k2": (64, (128, 2048), SEED, False, "k1"),
        "k14": (64, (129, 2049), SEED + 11, True, "k13"),
        "k2_cp_big": (128, (64, 512, 4096), SEED + 17, False, "k1_cp_big"),
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
            fwd = cp_mlp.cp_mlp_stacked_launch
            launch = cp_mlp.cp_mlp_stacked_backward_launch
        else:
            ops = cp_mlp.cp_mlp_operands(cp_params, d_layers, cp_spec, d_spec)
            fwd = cp_mlp.cp_mlp_launch
            launch = cp_mlp.cp_mlp_backward_launch
        _, vsave, hsave = fwd(ops, x, cp_spec, d_spec, train=True)
        args = (x, vsave, hsave, dout, ops[1], ops[2], cp_spec, d_spec)
        shape = f"C={c}, R={res}, F=16, MLP {16 * len(res)}->64->16"
        out[key] = (lambda launch=launch, args=args: launch(*args), shape)
        fargs = (fwd, ops, x, cp_spec, d_spec)
        out[fwd_key] = (lambda a=fargs: a[0](*a[1:], train=True), shape + ", training")
        out[fwd_key + "_eval"] = (lambda a=fargs: a[0](*a[1:]), shape + ", eval")

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
    shape = "SH 4, 16 features, MLP 32->64->64->3"
    out["k4"] = (lambda: sh_mlp.sh_mlp_backward_launch(*sh_args), shape)
    out["k3"] = (lambda: sh_mlp.sh_mlp_launch(sh_ops, feats, dirs, r_spec, 4, train=True),
                 shape + ", training")
    out["k3_eval"] = (lambda: sh_mlp.sh_mlp_launch(sh_ops, feats, dirs, r_spec, 4),
                      shape + ", eval")
    out.update(jac_cases(device, order, wanted))
    out.update(hash_cases(device, order, wanted))
    out.update(hash_jac_cases(device, order, wanted))
    out.update(vm_cases(device, order, wanted))
    return out


def _line_tables(gen, c, resolutions, device):
    """Per resolution, a (3, R, C) bf16 stack of 0.1 N(0, 1) lines."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp

    return {r: cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
            .to(device) for r in resolutions}


def jacb_fwd_operands(device, order, c=64, f=16, resolutions=(128, 2048), seed=SEED + 7):
    """Per resolution of a NeuS CP encoding (``chip_smoke.py``'s K9/K10
    phase: bf16 0.1 N(0, 1) lines, an N(0, 1)/8 basis): the arguments of one
    K9 launch, ``(lines, basis, u3, r)``, and the generator, to draw on."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    tables = _line_tables(gen, c, resolutions, device)
    basis = (torch.randn((c, f), generator=gen) / 8.0).to(torch.bfloat16).to(device)
    u3 = positions(gen, order).T.contiguous().to(device)
    return [(tables[r], basis, u3, r) for r in resolutions], gen


def jac_operands(device, order, c=64, f=16, resolutions=(128, 2048), seed=SEED + 7):
    """Per resolution of a NeuS CP encoding (``jacb_fwd_operands``, N(0, 1)
    cotangents): the arguments of one K10 launch, ``(u3, vsave, gdsave, denc,
    djac, basis, r)``, with the residuals from one training-mode K9 launch."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp

    fwd, gen = jacb_fwd_operands(device, order, c, f, resolutions, seed)
    u3 = fwd[0][2]
    denc = torch.randn((f, N), generator=gen).to(device)
    djac = torch.randn((3, f, N), generator=gen).to(device)
    out = []
    for lines, basis, _, r in fwd:
        _, _, vsave, gdsave = cpp.cp_product_jac_basis_launch(lines, basis, u3, r, train=True)
        out.append((u3, vsave, gdsave, denc, djac, basis, r))
    return out


def raw_jac_operands(device, order, c=64, resolutions=(128, 2048), seed=SEED + 19):
    """Per resolution of a raw-product NeuS encoding (``chip_smoke.py``'s
    K7/K8 phase: bf16 0.1 N(0, 1) lines, N(0, 1) f32 cotangents): the
    arguments of one K8 launch, ``(u3, vsave, gdsave, dprod, djac, r)``, with
    the residuals from one training-mode K7 launch."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp

    gen = torch.Generator().manual_seed(seed)
    tables = {r: cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
              .to(device) for r in resolutions}
    u3 = positions(gen, order).T.contiguous().to(device)
    dprod = torch.randn((c, N), generator=gen).to(device)
    djac = torch.randn((3, c, N), generator=gen).to(device)
    out = []
    for r in resolutions:
        _, _, vsave, gdsave = cpp.cp_product_jac_launch(tables[r], u3, r, train=True)
        out.append((u3, vsave, gdsave, dprod, djac, r))
    return out


def prod_fwd_operands(device, order, c=64, resolutions=(128, 2048), seed=SEED + 27):
    """Per resolution of the finite-difference NeuS's CP encoding
    (``chip_smoke.py``'s K5/K6 phase: bf16 0.1 N(0, 1) lines): the arguments
    of one K5 launch, ``(lines, u3, r)``, and the generator, to draw on."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    tables = _line_tables(gen, c, resolutions, device)
    u3 = positions(gen, order).T.contiguous().to(device)
    return [(tables[r], u3, r) for r in resolutions], gen


def prod_operands(device, order, c=64, resolutions=(128, 2048), seed=SEED + 27):
    """Per resolution of the finite-difference NeuS's CP encoding
    (``prod_fwd_operands``, N(0, 1) f32 cotangents): the arguments of one K6
    launch, ``(lines, u3, vsave, dprod, r)``, with the residual from one
    training-mode K5 launch."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp

    fwd, gen = prod_fwd_operands(device, order, c, resolutions, seed)
    u3 = fwd[0][1]
    dprod = torch.randn((c, u3.shape[1]), generator=gen).to(device)
    out = []
    for lines, _, r in fwd:
        _, vsave = cpp.cp_product_launch(lines, u3, r, train=True)
        out.append((lines, u3, vsave, dprod, r))
    return out


def stacked_fwd_operands(device, order, seed=SEED + 11):
    """The arguments of one K11 launch at the stacked NeuS encoding (C=64,
    nested R=(129, 2049) on one (3, 2049, 128) table, F=16), ``(lines, basis,
    u3, 2049)``, and the generator, to draw on."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_stacked as cps
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init

    gen = torch.Generator().manual_seed(seed)
    spec = CPSpec(64, (129, 2049), 16)
    params = cp_init(gen, spec, device)
    lines, basis = cps.stack_lines_fine(params, spec), cps.basis_stack(params, spec)
    u3 = positions(gen, order).T.contiguous().to(device)
    return (lines, basis, u3, 2049), gen


def stacked_jac_operands(device, order, seed=SEED + 11):
    """The arguments of one K12 launch at the stacked NeuS encoding
    (``stacked_fwd_operands``), residuals from one training-mode K11
    launch."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_stacked as cps

    (lines, basis, u3, _), gen = stacked_fwd_operands(device, order, seed)
    denc = torch.randn((32, N), generator=gen).to(device)
    djac = torch.randn((3, 32, N), generator=gen).to(device)
    _, _, vsave, gdsave = cps.cp_jac_basis_stacked_launch(lines, basis, u3, 2049, train=True)
    return (u3, vsave, gdsave, denc, djac, basis, 2049)


def jac_cases(device, order, wanted=None):
    """K10 summed over the bench NeuS scales R=128 and 2048 (one launch per
    scale, as a step runs it), K12 and cp_big's K10 summed over R=(64, 512,
    4096); K8 and K6 the same over the raw or finite-difference NeuS's and
    cp_big's scales; the forwards K5 and K9 (with cp_big's) the same, and
    K11, in training and eval mode."""
    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp
    from instant_nsr_pl_tpu_torch.ops import cp_stacked as cps

    def per_scale(ops, launch=cpp.cp_product_jac_basis_backward_launch):
        return lambda: [launch(*a) for a in ops]

    out = {}
    if wanted is None or "k10" in wanted:
        out["k10"] = (per_scale(jac_operands(device, order)), "C=64, F=16, R=128 + R=2048")
    if wanted is None or "k12" in wanted:
        stacked = stacked_jac_operands(device, order)
        out["k12"] = (lambda: cps.cp_jac_basis_stacked_backward_launch(*stacked),
                      "C=64, F=16, S=2, R_max=2049")
    if wanted is None or "k10_cp_big" in wanted:
        big = jac_operands(device, order, 128, 16, (64, 512, 4096), SEED + 17)
        out["k10_cp_big"] = (per_scale(big), "C=128, F=16, R=64 + 512 + 4096")
    prod = cpp.cp_product_backward_launch
    if wanted is None or "k6" in wanted:
        out["k6"] = (per_scale(prod_operands(device, order), prod), "C=64, R=128 + R=2048")
    if wanted is None or "k6_cp_big" in wanted:
        big = prod_operands(device, order, 128, (64, 512, 4096), SEED + 29)
        out["k6_cp_big"] = (per_scale(big, prod), "C=128, R=64 + 512 + 4096")
    # the forwards K5, K9 / cp_big's K9 (summed over the scales, a launch each)
    # and K11, in training and in eval mode
    forwards = {
        "k5": (prod_fwd_operands, (64, (128, 2048), SEED + 27), "C=64, R=128 + R=2048"),
        "k5_cp_big": (prod_fwd_operands, (128, (64, 512, 4096), SEED + 29),
                      "C=128, R=64 + 512 + 4096"),
        "k9": (jacb_fwd_operands, (64, 16, (128, 2048)), "C=64, F=16, R=128 + R=2048"),
        "k9_cp_big": (jacb_fwd_operands, (128, 16, (64, 512, 4096), SEED + 17),
                      "C=128, F=16, R=64 + 512 + 4096"),
    }
    for key, (make, args, shape) in forwards.items():
        if wanted is None or wanted & {key, key + "_eval"}:
            ops, _ = make(device, order, *args)
            launch = cpp.cp_product_launch if key.startswith("k5") else \
                cpp.cp_product_jac_basis_launch
            out[key] = (lambda o=ops, l=launch: [l(*a, train=True) for a in o],
                        shape + ", training")
            out[key + "_eval"] = (lambda o=ops, l=launch: [l(*a) for a in o], shape + ", eval")
    if wanted is None or wanted & {"k11", "k11_eval"}:
        k11_args, _ = stacked_fwd_operands(device, order)
        out["k11"] = (lambda a=k11_args: cps.cp_jac_basis_stacked_launch(*a, train=True),
                      "C=64, F=16, S=2, R_max=2049, training")
        out["k11_eval"] = (lambda a=k11_args: cps.cp_jac_basis_stacked_launch(*a),
                           "C=64, F=16, S=2, R_max=2049, eval")
    raw = cpp.cp_product_jac_backward_launch
    if wanted is None or "k8" in wanted:
        out["k8"] = (per_scale(raw_jac_operands(device, order), raw), "C=64, R=128 + R=2048")
    if wanted is None or "k8_cp_big" in wanted:
        big = raw_jac_operands(device, order, 128, (64, 512, 4096), SEED + 23)
        out["k8_cp_big"] = (per_scale(big, raw), "C=128, R=64 + 512 + 4096")
    return out


def hash_spec():
    """The bench hash grid (bench.py _ENCODINGS["hash"]: 16 levels, F=2,
    2^19 rows per hashed level), as ``chip_smoke.py`` holds HG1/HG2."""
    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec

    return HashGridSpec(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                        base_resolution=16, per_level_scale=1.447269237440378)


def hash_operands(device, order, seed=SEED + 13):
    """HG2's arguments at the bench hash shape: a table of values of order 1,
    positions in the unit box and N(0, 1) output cotangents."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = hash_spec()
    gen = torch.Generator().manual_seed(seed)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(device)
    x = (torch.rand((N, 3), generator=gen) if order == "uniform"
         else positions(gen, order).clamp(0.0, 1.0)).to(device)
    ct = torch.randn((N, spec.n_output_dims), generator=gen).to(device)
    return table, x, ct, spec


def hash_cases(device, order, wanted=None):
    """HG2's table gradient, and with the position gradient; HG1, and where
    the checkout's table is row-major (T, F), HG1 launched on four chunks of
    N in turn (each chunk's output stays in L2 across its levels) and the
    (F, T) -> (T, F) copy of the table that a feature-major parameter would
    need before each row-major read."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    keys = {"hg2", "hg2_dx", *CASES_OF["hashgrid_fwd"]}
    if wanted is not None and not wanted & keys:
        return {}
    table, x, ct, spec = hash_operands(device, order)
    shape = "16 levels, F=2, 2^19 rows"
    out = {
        "hg2": (lambda: hg.hashgrid_backward_launch(table, x, ct, spec), shape),
        "hg2_dx": (lambda: hg.hashgrid_backward_launch(table, x, ct, spec, with_dx=True),
                   shape + ", with d x"),
        "hg1": (lambda: hg.hashgrid_forward_launch(table, x, spec), shape),
    }
    if tuple(table.shape) == (spec.total_params, spec.n_features_per_level):
        chunks = x.chunk(4)
        out["hg1_chunked"] = (lambda: [hg.hashgrid_forward_launch(table, c, spec)
                                       for c in chunks], shape + ", 4 launches of N/4")
        ft = table.T.contiguous()
        dst = torch.empty_like(table)
        out["ft_to_tf"] = (lambda: dst.copy_(ft.T), "(F, T) -> (T, F) copy of the table")
    return out


def neus_hash_spec():
    """configs/neus-synthetic.yaml's grid (12 levels, F=2, 2^18 rows, base 32:
    3 dense and 9 hashed levels), as ``chip_smoke.py`` holds HG3/HG4."""
    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec

    return HashGridSpec(n_levels=12, n_features_per_level=2, log2_hashmap_size=18,
                        base_resolution=32, per_level_scale=1.3195079107728942)


def hash_jac_operands(device, order, n, seed=SEED + 31):
    """HG3/HG4's arguments at ``neus_hash_spec`` for n samples: a table of
    values of order 1, positions in the unit box (uniform, or ray-ordered),
    N(0, 1) cotangents of the features (n, L F) and of the Jacobian (3, n,
    L F)."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = neus_hash_spec()
    gen = torch.Generator().manual_seed(seed)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(device)
    x = (torch.rand((n, 3), generator=gen) if order == "uniform"
         else positions(gen, order, n).clamp(0.0, 1.0)).to(device)
    ct_f = torch.randn((n, spec.n_output_dims), generator=gen).to(device)
    ct_j = torch.randn((3, n, spec.n_output_dims), generator=gen).to(device)
    return table, x, ct_f, ct_j, spec


def hash_jac_cases(device, order, wanted=None):
    """HG3 at a NeuS hash step's capacity (N = 65,536) and at an eval chunk's
    (``hg3_eval``, 262,144); HG4's table gradient at 65,536, with the position
    gradient (``hg4_dx``), and at 262,144 (``hg4_262k``)."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    keys = {*CASES_OF["hashgrid_jac_fwd"], *CASES_OF["hashgrid_jac_bwd"]}
    if wanted is not None and not wanted & keys:
        return {}
    out = {}
    for n, fwd_key, bwd_keys in ((65536, "hg3", ("hg4", "hg4_dx")),
                                 (N, "hg3_eval", ("hg4_262k",))):
        table, x, ct_f, ct_j, spec = hash_jac_operands(device, order, n)
        shape = f"12 levels, F=2, 2^18 rows, N={n}"
        out[fwd_key] = (lambda a=(table, x, spec): hg.hashgrid_jac_forward_launch(*a), shape)
        for key in bwd_keys:
            args = (table, x, ct_f, ct_j, spec, None, key.endswith("_dx"))
            out[key] = (lambda a=args: hg.hashgrid_jac_backward_launch(*a),
                        shape + (", with d x" if key.endswith("_dx") else ""))
    return out


def vm_spec():
    """The VM NeRF's encoding (``configs/nerf-vm-synthetic.yaml``: 16
    components, planes 512^2 and 256^2, lines of 2048 rows, 2 scales), as
    ``chip_smoke.py`` holds VM1 / VM2."""
    from instant_nsr_pl_tpu_torch.ops.vm import VMSpec

    return VMSpec(n_components=16, plane_resolution=512, line_resolution=2048, n_scales=2)


def vm_operands(device, order, n=N, seed=SEED + 37):
    """VM1 / VM2's arguments at ``vm_spec``: the tables of ``vm_init``,
    positions in the unit box (uniform, or ray-ordered) and N(0, 1) output
    cotangents (n, 96)."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import vm

    spec = vm_spec()
    gen = torch.Generator().manual_seed(seed)
    params = vm.vm_init(gen, spec, device)
    x = (torch.rand((n, 3), generator=gen) if order == "uniform"
         else positions(gen, order, n).clamp(0.0, 1.0)).to(device)
    ct = torch.randn((n, spec.n_output_dims), generator=gen).to(device)
    return params, x, ct, spec


def vm_cases(device, order, wanted=None):
    """VM1 (``vm1``), VM2's table gradients (``vm2``) and with the position
    gradient (``vm2_dx``) at N = 262,144 (the VM NeRF's step capacity), each
    through its public launch."""
    from instant_nsr_pl_tpu_torch.ops import vm

    keys = {*CASES_OF["vm_fwd"], *CASES_OF["vm_bwd"]}
    if wanted is not None and not wanted & keys:
        return {}
    params, x, ct, spec = vm_operands(device, order)
    shape = "C=16, planes 512 / 256, lines 2048, 2 scales"
    return {
        "vm1": (lambda: vm.vm_forward_launch(params, x, spec), shape),
        "vm2": (lambda: vm.vm_backward_launch(params, x, ct, spec), shape),
        "vm2_dx": (lambda: vm.vm_backward_launch(params, x, ct, spec, with_dx=True),
                   shape + ", with d x"),
    }


def step_cases(path, device, wanted=None):
    """The forward kernels, K3, K8, K6 and HG2 on a training step's own operands,
    as ``chip_smoke.py`` saved them: per case, ``kind`` "prod_fwd", "jacb" or
    "jacs" (``launches``: each of the step's training-mode K5, K9 or K11
    launches' arguments, ``(lines, u3, R)`` or ``(lines, basis, u3, R)``), "cp" (``ops``, ``x``,
    ``cp`` = (C, R, F), ``mlp`` = (dim_in, dim_out, width, hidden layers),
    ``stacked``, ``train``), "hash" (``table`` (T, F), ``x``, ``spec`` the
    HashGridSpec fields, ``mask``), "hash_bwd" (HG2: ``table``, ``x``,
    ``dout``, ``spec``, ``mask``, ``with_dx``), "sh" (``ops``, ``feats``, ``dirs``,
    ``mlp``, ``degree``, ``train``), "vm_fwd" / "vm_bwd" (VM1 / VM2:
    ``params``, ``x``, ``spec`` the VMSpec fields; VM2 also ``dout``,
    ``with_dx``), "raw" (``launches``: each of the
    step's K8 launches' arguments) or "prod" (``launches``: each of the
    step's K6 launches' (lines, u3, d prod, R); the residual vsave is made
    again by the checkout's K5 in training mode, equal to the bit to the
    step's own)."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_mlp, sh_mlp
    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp
    from instant_nsr_pl_tpu_torch.ops import cp_stacked as cps
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec
    from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec

    out = {}
    # the forwards' training-mode launches, looked up when a case runs
    forwards = {"prod_fwd": (cpp, "cp_product_launch", 1), "jacb": (cpp,
                "cp_product_jac_basis_launch", 2), "jacs": (cps, "cp_jac_basis_stacked_launch", 2)}
    for key, e in torch.load(path, map_location=device, weights_only=True).items():
        if wanted is not None and key not in wanted:
            continue
        if e["kind"] in forwards:
            mod, name, at = forwards[e["kind"]]
            calls = [tuple(a) for a in e["launches"]]
            out[key] = (lambda c=calls, m=mod, nm=name: [getattr(m, nm)(*a, train=True)
                                                         for a in c],
                        "N=" + " + ".join(str(a[at].shape[1]) for a in calls))
            continue
        if e["kind"] == "raw":
            calls = [tuple(a) for a in e["launches"]]
            out[key] = (lambda c=calls: [cpp.cp_product_jac_backward_launch(*a) for a in c],
                        f"N={calls[0][0].shape[1]}, {len(calls)} launches")
            continue
        if e["kind"] == "prod":
            calls = [(lines, u3, cpp.cp_product_launch(lines, u3, int(r), train=True)[1], dprod,
                      int(r)) for lines, u3, dprod, r in e["launches"]]
            out[key] = (lambda c=calls: [cpp.cp_product_backward_launch(*a) for a in c],
                        "N=" + " + ".join(str(a[1].shape[1]) for a in calls))
            continue
        if e["kind"] == "sh":
            din, dout, width, nh = e["mlp"]
            spec = MLPSpec(dim_in=int(din), dim_out=int(dout), n_neurons=int(width),
                           n_hidden_layers=int(nh))
            out[key] = (lambda e=e, s=spec: sh_mlp.sh_mlp_launch(
                tuple(e["ops"]), e["feats"], e["dirs"], s, int(e["degree"]), train=e["train"]),
                f"N={e['feats'].shape[0]}, train={e['train']}")
            continue
        if e["kind"] in ("vm_fwd", "vm_bwd"):
            from instant_nsr_pl_tpu_torch.ops import vm

            spec = vm.VMSpec(**e["spec"])
            if e["kind"] == "vm_fwd":
                fn = lambda e=e, s=spec: vm.vm_forward_launch(e["params"], e["x"], s)
            else:
                fn = lambda e=e, s=spec: vm.vm_backward_launch(e["params"], e["x"], e["dout"], s,
                                                               e["with_dx"])
            out[key] = (fn, f"N={e['x'].reshape(-1, 3).shape[0]}")
            continue
        x = e["x"]
        if e["kind"] in ("hash", "hash_bwd", "hash_jac", "hash_jac_bwd"):
            spec = hg.HashGridSpec(**e["spec"])
            table = e["table"]
            try:
                hg._check_spec(spec, table)
            except ValueError:  # a feature-major checkout
                table = table.T.contiguous()
            launch = {"hash": lambda t, x, s, e: hg.hashgrid_forward_launch(t, x, s, e["mask"]),
                      "hash_bwd": lambda t, x, s, e: hg.hashgrid_backward_launch(
                          t, x, e["dout"], s, e["mask"], e["with_dx"]),
                      "hash_jac": lambda t, x, s, e: hg.hashgrid_jac_forward_launch(
                          t, x, s, e["mask"]),
                      "hash_jac_bwd": lambda t, x, s, e: hg.hashgrid_jac_backward_launch(
                          t, x, e["ct_feat"], e["ct_jac"], s, e["mask"], e["with_dx"])}[e["kind"]]
            out[key] = (lambda l=launch, t=table, x=x, s=spec, e=e: l(t, x, s, e),
                        f"N={x.reshape(-1, 3).shape[0]}")
            continue
        c, res, f = e["cp"]
        din, dout, width, nh = e["mlp"]
        cp_spec = CPSpec(int(c), tuple(int(r) for r in res), int(f))
        mlp_spec = MLPSpec(dim_in=int(din), dim_out=int(dout), n_neurons=int(width),
                           n_hidden_layers=int(nh))
        launch = cp_mlp.cp_mlp_stacked_launch if e["stacked"] else cp_mlp.cp_mlp_launch
        ops = e["ops"]
        if not e["stacked"]:
            ops = (list(ops[0]), *ops[1:])
        out[key] = (lambda l=launch, o=tuple(ops), x=x, cs=cp_spec, ms=mlp_spec, t=e["train"]:
                    l(o, x, cs, ms, train=t), f"N={x.shape[0]}, train={e['train']}")
    return out


def _merged_rows(rows, group):
    """Rows left after merging equal rows within each group of ``group``
    consecutive entries of ``rows`` (one level's or axis's rows, (N,) or
    (k, N): merged per leading index)."""
    import torch

    rows = rows.reshape(-1, rows.shape[-1])
    k, n = rows.shape
    n_groups = -(-n // group)
    pad = n_groups * group - n
    if pad:
        rows = torch.cat([rows, rows[:, -1:].expand(k, pad)], dim=1)
    g = rows.reshape(k, n_groups, group).sort(dim=-1).values
    distinct = 1 + (g[..., 1:] != g[..., :-1]).sum(-1)
    return int(distinct.sum())  # the padding repeats a kept row: nothing new


def vm_window_merge(rows, upd=None, run=16):
    """A plain emulation of VM2's merge window (``csrc/vm_bwd.cu``) on one
    table: ``rows`` (T, n) the T taps' rows of each sample (-1 for none),
    ``upd`` (T, n, C) their updates or None. The samples are cut into runs of
    ``run`` consecutive samples (a lane group's walk); along a run, a tap whose
    row equals one of the previous sample's rows takes over that row's
    running sum, and a previous row that no tap takes over is flushed: one
    atomic of its sum. Returns the flushed (rows (M,), sums (M, C) or None), in
    no particular order; their index_add_ is the table gradient."""
    import torch

    t, n = rows.shape
    runs = -(-n // run)
    pad = runs * run - n
    r_all = torch.cat([rows, rows.new_full((t, pad), -1)], dim=1).reshape(t, runs, run)
    u_all = None
    if upd is not None:
        u_all = torch.cat([upd, upd.new_zeros((t, pad, upd.shape[-1]))], dim=1)
        u_all = u_all.reshape(t, runs, run, upd.shape[-1])
    prev = rows.new_full((t, runs), -1)
    acc = None if upd is None else upd.new_zeros((t, runs, upd.shape[-1]))
    out_rows, out_sums = [], []

    def flush(mask):
        out_rows.append(prev[mask])
        if acc is not None:
            out_sums.append(acc[mask])

    for s in range(run):
        r = r_all[:, :, s]
        match = r[:, None, :] == prev[None, :, :]  # (new tap, previous tap, run)
        flush(~match.any(0) & (prev >= 0))
        if acc is not None:
            acc = u_all[:, :, s] + (match[..., None].to(acc.dtype) * acc[None]).sum(1)
        prev = r
    flush(prev >= 0)
    return torch.cat(out_rows), (torch.cat(out_sums) if acc is not None else None)


def vm_emulated_backward(params, x, ct, spec, run=16):
    """VM2's table gradients as its merge window adds them, on the CPU: per
    table the updates VM2 forms (``w_p * (g * lf)``, ``w_l * (g * pf)``, as
    ``ops/vm.py`` ``vm_backward_plain`` forms them), merged along runs of
    ``run`` samples by ``vm_window_merge`` and the flushed sums added with
    ``index_add_`` in float64. Returns (gradients, atomics of row per
    table)."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import vm

    xf = x.reshape(-1, 3).float()
    n, c = xf.shape[0], spec.n_components
    ct2 = ct.reshape(n, 3 * spec.n_scales, c).float()
    grads, atomics = {}, {}
    for s in range(spec.n_scales):
        for k, axes in enumerate(vm.VMSpec.AXES):
            pk, lk = f"plane_{s}_{k}", f"line_{s}_{k}"
            prow, pw = vm._plane_taps(xf, axes, spec.plane_res(s))
            lrow, lw = vm._line_taps(xf, axes, spec.line_resolution)
            pf = vm._gather_weighted(params[pk], prow, pw)
            lf = vm._gather_weighted(params[lk], lrow, lw)
            g = ct2[:, 3 * s + k]
            for key, rows, w, other in ((pk, prow, pw, lf), (lk, lrow, lw, pf)):
                rows_out, sums = vm_window_merge(rows, w[..., None] * (g * other)[None], run)
                grads[key] = torch.zeros(params[key].shape, dtype=torch.float64).index_add_(
                    0, rows_out, sums.double())
                atomics[key] = rows_out.numel()
    return grads, atomics


def vm_merge_stats(device, order, n=N, x=None):
    """What VM2's merge window removes from this order's operands (or from
    the positions ``x``, a step's own): per table kind, the row updates (4
    per sample and plane, 2 per sample and line), the atomics the merge
    window leaves with runs of 8, 16 and 32 samples, and the distinct rows
    of each run of 16 and of each 32 samples (what any merge within them
    could leave)."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import vm

    spec = vm_spec()
    if x is None:
        _, x, _, _ = vm_operands(device, order, n)
    x = x.reshape(-1, 3).float()
    n = x.shape[0]
    out = {}
    for s in range(spec.n_scales):
        for k, axes in enumerate(vm.VMSpec.AXES):
            for kind, (rows, _) in (("plane", vm._plane_taps(x, axes, spec.plane_res(s))),
                                    ("line", vm._line_taps(x, axes, spec.line_resolution))):
                key = f"{kind}_{spec.plane_res(s)}" if kind == "plane" else "line"
                e = out.setdefault(key, {"updates": 0, "window_8": 0, "window_16": 0,
                                         "window_32": 0, "distinct_16": 0, "distinct_32": 0})
                e["updates"] += rows.numel()
                for run in (8, 16, 32):
                    e[f"window_{run}"] += int(vm_window_merge(rows, run=run)[0].numel())
                for run in (16, 32):
                    pad = -n % run
                    r = torch.cat([rows, rows[:, -1:].expand(-1, pad)], dim=1)
                    width = rows.shape[0] * run  # a run's taps
                    r = r.reshape(rows.shape[0], -1, run).permute(1, 0, 2).reshape(-1, width)
                    e[f"distinct_{run}"] += _merged_rows(r, width)
    return out


def merge_stats(device, order, n=N):
    """What merging equal rows would remove, from this order's operands:
    HG2's per-level (sample, corner) row updates within a warp of 32
    consecutive samples, merged per corner (one ``__match_any_sync`` per
    corner) and across the 8 corners; K10's per-axis row updates (two per
    sample) within runs of 16 and 64 consecutive samples, as a window of
    two rows walking the run in order merges them, and as distinct rows."""
    import torch

    from instant_nsr_pl_tpu_torch.ops import cp_product as cpp
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    out = {"hg2": [], "k10": {}}
    _, x, _, spec = hash_operands(device, order)
    xt = x.T.contiguous()
    for lv in range(spec.n_levels):
        idx, _ = hg.level_corner_indices(spec, xt, lv)  # (8, N)
        per_corner = _merged_rows(idx, 32)
        across = _merged_rows(idx.reshape(8, -1, 32).permute(1, 0, 2).reshape(-1, 8 * 32), 8 * 32)
        out["hg2"].append({"level": lv, "hashed": spec.level_hashed[lv],
                           "updates": 8 * n, "after_corner_merge": per_corner,
                           "after_all_corner_merge": across})
    gen = torch.Generator().manual_seed(SEED + 7)
    u3 = positions(gen, order, n).T.to(device)
    for r in (128, 2048, 64, 512, 4096):
        i0 = torch.stack([cpp.tent_coords(u3[a], r)[0] for a in range(3)])  # (3, N)
        entry = {"updates": 2 * 3 * n}
        for run in (16, 64):
            blocks = i0.reshape(3, -1, run)
            d = (blocks[..., 1:] - blocks[..., :-1]).abs()
            entering = torch.where(d == 0, 0, torch.where(d == 1, 1, 2)).sum()
            entry[f"window_{run}"] = int(2 * 3 * (n // run) + entering)
            both = torch.cat([i0, i0 + 1], dim=1).reshape(3, 2, -1, run).permute(0, 2, 1, 3)
            entry[f"distinct_{run}"] = _merged_rows(both.reshape(3 * (n // run), 2 * run), 2 * run)
        out["k10"][r] = entry
    return out


def _print_vm_merge(order, stats):
    for key, e in stats.items():
        print(f"[merge] vm2 {order} {key}: {e['updates']} row updates; merge window "
              f"{e['window_8']} / {e['window_16']} / {e['window_32']} (runs of 8 / 16 / 32); "
              f"distinct {e['distinct_16']} / {e['distinct_32']} (16 / 32 samples)", flush=True)


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


def _time(result, key, fn, shape, smi):
    """Time one case back to back and as device time into ``result``."""
    import torch

    fn()
    torch.cuda.synchronize()
    result["ms"][key] = time_ms(fn)
    dev, by_name = device_ms(fn)
    result.setdefault("device_ms", {})[key] = dev
    result.setdefault("device_kernels", {})[key] = by_name
    parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))
    print(f"[time] {key} ({shape}): {result['ms'][key]:.4f} ms back to back; device "
          f"{dev:.4f} ms ({parts})  [{smi}]", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--order", default="uniform",
                    help="uniform, ray, stencil (K5 and K6 cases only), or several "
                         "separated by commas")
    ap.add_argument("--cases", default=None,
                    help="time only these cases (comma-separated: k2, k14, k2_cp_big, k4, k10, "
                         "k12, k10_cp_big, k8, k8_cp_big, k6, k6_cp_big, hg2, hg2_dx, k1, "
                         "k1_eval, k13, "
                         "k13_eval, k1_cp_big, k1_cp_big_eval, k3, k3_eval, hg1, hg1_chunked, "
                         "ft_to_tf, k5, k5_eval, k5_cp_big, k5_cp_big_eval, k9, k9_eval, k11, "
                         "k11_eval, k9_cp_big, k9_cp_big_eval, hg3, hg3_eval, hg4, hg4_dx, "
                         "hg4_262k, vm1, vm2, vm2_dx), only their sources' cuts and, with "
                         "--step-operands, only "
                         "these cases of the step")
    ap.add_argument("--merge-stats", action="store_true",
                    help="also count the row updates a merge of equal rows would remove")
    ap.add_argument("--step-operands", default=None,
                    help="also time the forward kernels (K1, K13, K3, K5, K9, K11, HG1, HG3, "
                         "VM1), K8, K6, HG2, HG4 and VM2 on these saved training-step operands")
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
        wanted = set(args.cases.split(",")) if args.cases else None
        bwd_stems = [stem for stem, keys in CASES_OF.items()
                     if (wanted is None or wanted & set(keys))
                     and (cuda_build.CSRC / f"{stem}.cu").exists()]
        cut_stems = set(bwd_stems)  # the cuts of the wanted cases' sources only
        if args.step_operands:
            extra = [s for s in ("cp_mlp_fwd", "hashgrid_fwd", "hashgrid_bwd", "sh_mlp_fwd",
                                 "cp_jac_basis_bwd", "cp_product_jac_bwd", "cp_product_bwd",
                                 "cp_product_fwd", "cp_jac_basis_fwd", "hashgrid_jac_fwd",
                                 "hashgrid_jac_bwd", "vm_fwd", "vm_bwd")
                     if (cuda_build.CSRC / f"{s}.cu").exists()]
            bwd_stems = list(dict.fromkeys([*bwd_stems, *extra]))
        stems = list(dict.fromkeys(s for b in bwd_stems for s in (b, *PARTNER[b])))
        jobs = [(stem, cuda_build.CSRC / f"{stem}.cu", tmp / f"{stem}.so") for stem in stems]
        variants = {}
        for name, (stem, edits) in (CUTS.items() if args.cuts else ()):
            if stem not in cut_stems:
                continue
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
        for name in (*bwd_stems, *variants):
            for line in ptxas[name]:
                print(f"[ptxas] {name}: {line}", flush=True)
        timed, loaded = {}, []
        for order in orders:
            if args.merge_stats:
                result.setdefault("merge", {})[order] = stats = merge_stats(device, order)
                for e in stats["hg2"]:
                    print(f"[merge] hg2 {order} level {e['level']} (hashed {e['hashed']}): "
                          f"{e['updates']} row updates, {e['after_corner_merge']} after a merge "
                          f"per corner in a warp of 32, {e['after_all_corner_merge']} across "
                          f"corners", flush=True)
                for r, e in stats["k10"].items():
                    print(f"[merge] k10 {order} R={r}: {e['updates']} row updates; window of two "
                          f"rows {e['window_16']} (runs of 16), {e['window_64']} (64); distinct "
                          f"{e['distinct_16']} / {e['distinct_64']}", flush=True)
                stats["vm2"] = vm_merge_stats(device, order)
                _print_vm_merge(order, stats["vm2"])
            # the stencil order is the finite-difference NeuS's: K5 and K6 cases only
            want = wanted if order != "stencil" else (wanted or set(STENCIL_CASES)) & STENCIL_CASES
            for key, (fn, shape) in (cases(device, order, want) if want != set() else {}).items():
                if want is not None and key not in want:
                    continue
                key = f"{key}@{order}"
                timed[key] = fn
                _time(result, key, fn, shape, smi)
        if args.step_operands:
            steps = step_cases(args.step_operands, device, wanted)
            for key, (fn, shape) in steps.items():
                key = f"{key}@step"
                timed[key] = fn
                _time(result, key, fn, shape, smi)
            if args.merge_stats and "vm1" in steps:
                x = torch.load(args.step_operands, map_location=device,
                               weights_only=True)["vm1"]["x"]
                stats = {"vm2": vm_merge_stats(device, "step", x=x)}
                result.setdefault("merge", {})["step"] = stats
                _print_vm_merge("step", stats["vm2"])
        for name, stem in variants.items():
            saved = cuda_build._LIBS[stem]
            loaded.append(ctypes.CDLL(str(tmp / f"{name}.so")))  # kept alive: one id each
            cuda_build._LIBS[stem] = loaded[-1]
            cuda_build.PLANS.clear()  # a variant may fit more blocks per SM
            entry = {"ptxas": ptxas[name]}
            cut_keys = [k for k in CUT_CASES.get(name, CASES_OF[stem])
                        if wanted is None or k in wanted]
            for key in [f"{k}@{o}" for k in cut_keys for o in orders
                        if o != "stencil" or k in STENCIL_CASES] + [
                            f"{k}@step" for k in cut_keys if f"{k}@step" in timed]:
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
