// Per-level helpers of the multiresolution hash grid, shared by HG1
// (csrc/hashgrid_fwd.cu), HG2 (csrc/hashgrid_bwd.cu), HG3
// (csrc/hashgrid_jac_fwd.cu), HG4 (csrc/hashgrid_jac_bwd.cu) and HG5-HG8
// (csrc/hashgrid_lattice_{fwd,bwd}.cu): the taps of a level, the row loads,
// the corner partials of the Jacobian, the vector atomics, the merge of equal
// rows within a warp and across a block's warps that HG2 and HG4 share
// (scan_runs, merge_edges), and the 27-point lattice of a dedup level.
//
// The level layout is the JAX package's (instant_nsr_pl_tpu/ops/hashgrid.py
// HashGridSpec and _level_corner_indices, :44-222): per level a float32 scale
// s, a resolution R, a row count T_l and a row offset into the table, which
// the port keeps row-major, (total, F) float32 (the JAX package's is
// feature-major, (F, total)); a dense level indexes x + y*R + z*R*R, a hashed
// one (x * 1) ^ (y * 2654435761) ^ (z * 805459861) mod T_l, both in uint32
// arithmetic. For one coordinate:
//   pos = fma(x, s, 0.5)   (one rounding, as the JAX package's jitted code
//                           contracts x * s + 0.5)
//   g = floor(pos), frac = pos - g
//   corner c (bits b_d = (c >> d) & 1): clip(g + b, 0, R - 1) per axis,
//   weight ((p_0 * p_1) * p_2) with p_d = b_d ? frac_d : 1 - frac_d.
// Build with --fmad=false: every other product and sum rounds on its own, as
// in the plain PyTorch version (ops/hashgrid.py).
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace insr {

constexpr int kHashMaxLevels = 32;
constexpr int kHashBlock = 128;

// g: the level's tap-dedup block size (0: per-sample taps). The dedup
// levels are a prefix of the levels; HG1-HG4 skip them and HG5-HG8
// (csrc/hashgrid_lattice_{fwd,bwd}.cu) read them from one 27-point lattice
// per aligned block of g samples.
struct HashLevel {
  float scale;
  uint32_t res;
  uint32_t size;
  uint32_t offset;
  int hashed;
  int g;
};

struct HashLevels {
  HashLevel l[kHashMaxLevels];
};

// The number of leading dedup levels (g > 0): the first level HG1-HG4 run.
inline int lattice_levels(const HashLevels& levels, int n_levels) {
  int k = 0;
  while (k < n_levels && levels.l[k].g > 0) ++k;
  return k;
}

// The 8 corners of one sample in one level: global rows and weights, plus
// frac for the position gradient.
struct Taps {
  uint32_t row[8];
  float w[8];
  float frac[3];
};

__device__ __forceinline__ Taps level_taps(const HashLevel& lv, float x0, float x1,
                                           float x2) {
  Taps t;
  const float xs[3] = {x0, x1, x2};
  int gi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = fmaf(xs[d], lv.scale, 0.5f);
    const float g = floorf(pos);
    t.frac[d] = pos - g;
    gi[d] = static_cast<int>(g);
  }
  const int rmax = static_cast<int>(lv.res) - 1;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t cu[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int v = gi[d] + ((c >> d) & 1);
      cu[d] = static_cast<uint32_t>(v < 0 ? 0 : (v > rmax ? rmax : v));
    }
    uint32_t local;
    if (lv.hashed) {
      local = (cu[0] * 1u ^ cu[1] * 2654435761u ^ cu[2] * 805459861u) % lv.size;
    } else {
      local = cu[0] + cu[1] * lv.res + cu[2] * lv.res * lv.res;
    }
    t.row[c] = local + lv.offset;
    float w = (c & 1) ? t.frac[0] : 1.0f - t.frac[0];
    w = w * (((c >> 1) & 1) ? t.frac[1] : 1.0f - t.frac[1]);
    w = w * (((c >> 2) & 1) ? t.frac[2] : 1.0f - t.frac[2]);
    t.w[c] = w;
  }
  return t;
}

// F floats at p (aligned to 4 * F bytes, up to 16) as vector loads.
template <int F>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
  }
}

// Row `row` of the row-major (T, F) float32 table: one vector load (8 bytes
// at F = 2, a quarter of one 32-byte sector).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, uint32_t row,
                                         float (&v)[F]) {
  load_vec<F>(table + static_cast<long long>(row) * F, v);
}

// The tents of corner c, p_d = frac_d where the corner sets bit d, else
// 1 - frac_d, and their products over the other two axes, excl_d: then
// d w_c / d x_d = sign_cd * excl_d * s in world units (JAX _jac_weights,
// ops/hashgrid.py:779). The plain versions compute (sign * excl) * s; the
// sign is exact, so (bit ? excl : -excl) * s rounds as they do.
__device__ __forceinline__ void corner_tents(const Taps& t, int c, float (&p)[3],
                                             float (&excl)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = ((c >> d) & 1) ? t.frac[d] : 1.0f - t.frac[d];
  excl[0] = p[1] * p[2];
  excl[1] = p[0] * p[2];
  excl[2] = p[0] * p[1];
}

// Add v to row `row` of the (T, F) f32 gradient: one vector atomic per 16
// bytes (Hopper, CUDA >= 12.1).
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ dtable, uint32_t row,
                                        const float (&v)[F]) {
  float* p = dtable + static_cast<long long>(row) * F;
  if constexpr (F == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < F; q += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + q), make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
    }
  }
}

// Where HG2's sums go: rows below `wide_rows` (its dense levels, whose rows
// take thousands of updates) into a (wide_rows, F) float64 scratch with
// float64 atomics, the rest into the (T, F) float32 gradient.
struct SplitRows {
  float* dtable;
  double* wide;
  uint32_t wide_rows;
};

template <int F>
__device__ __forceinline__ void add_row(const SplitRows& s, uint32_t row, const float (&v)[F]) {
  if (row < s.wide_rows) {
    double* p = s.wide + static_cast<long long>(row) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(p + f, static_cast<double>(v[f]));
  } else {
    add_row<F>(s.dtable, row, v);
  }
}

constexpr uint32_t kNoRow = 0xffffffffu;  // an idle lane's row, and an empty edge slot

// Per corner, each warp's first run [0] and last run [1] of a level's equal
// rows (row, sum), staged for the block merge.
template <int F>
struct EdgeRuns {
  uint32_t row[8][kHashBlock / 32][2];
  float val[8][kHashBlock / 32][2][F];
};

template <int F>
__device__ __forceinline__ bool nonzero(const float (&v)[F]) {
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) any = any || v[f] != 0.0f;
  return any;
}

// One level's corner c for a warp of 32 consecutive samples, each lane
// bringing its row (kNoRow for an idle lane) and update v: a segmented
// inclusive scan over each run of lanes with equal rows (a ray's neighbouring
// samples on a coarse level) sums the run in a fixed order into its last
// lane, and the warp's first and last run go to `edges` for the block merge.
// Returns whether this lane ends one of the other runs: it then adds the
// run's sum (v) itself. Called by whole warps.
template <int F>
__device__ __forceinline__ bool scan_runs(int c, uint32_t row, float (&v)[F],
                                          EdgeRuns<F>& edges) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t left = __shfl_up_sync(kAll, row, 1);
  const bool head = lane == 0 || left != row;  // the first lane of a run of equal rows
  const unsigned heads = __ballot_sync(kAll, head);
  if (heads != kAll) {
    const unsigned upto = lane == 31 ? kAll : (2u << lane) - 1u;
    const int start = 31 - __clz(heads & upto);
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float up = __shfl_up_sync(kAll, v[f], d);
        if (lane - d >= start) v[f] += up;
      }
    }
  }
  // run ends: lane 31 and every lane before a head; the warp's first run
  // ends at the lowest of them, its last at lane 31
  const unsigned tails = (heads >> 1) | 0x80000000u;
  const int first_end = __ffs(tails) - 1;
  if (lane == first_end || lane == 31) {
    const int k = lane == first_end ? 0 : 1;
    edges.row[c][warp][k] = row;
#pragma unroll
    for (int f = 0; f < F; ++f) edges.val[c][warp][k][f] = v[f];
    if (first_end == 31) edges.row[c][warp][1] = kNoRow;  // one run: no last run
    return false;
  }
  return (tails >> lane) & 1u;
}

// scan_runs, then the lane's own run added with one atomic (a float32
// vector atomic, or HG2's float64 ones on a dense level: SplitRows).
template <int F, typename Sink>
__device__ __forceinline__ void scatter_corner(int c, uint32_t row, float (&v)[F], bool active,
                                               EdgeRuns<F>& edges, Sink dtable) {
  if (scan_runs<F>(c, row, v, edges) && active) add_row<F>(dtable, row, v);
}

// The block merge of a level, after a barrier that follows every warp's
// scan_runs of its 8 corners: thread c < 8 walks corner c's edge runs in
// warp order, sums the runs that hold the same row (a run that straddles a
// warp boundary, or a whole block on one row) and adds each merged run once.
// With kSkipZero a merged run whose sum is zero in every feature adds
// nothing: the gradient starts at +0 and never holds -0, so adding +-0
// leaves it as it is.
template <int F, bool kSkipZero, typename Sink>
__device__ __forceinline__ void merge_edges(const EdgeRuns<F>& edges, Sink dtable) {
  if (threadIdx.x >= 8) return;
  const int c = threadIdx.x;
  uint32_t run_row = kNoRow;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int k = 0; k < 2 * (kHashBlock / 32); ++k) {
    const uint32_t r = edges.row[c][k >> 1][k & 1];
    if (r == kNoRow) continue;
    if (r != run_row) {
      if (run_row != kNoRow && (!kSkipZero || nonzero(acc))) add_row<F>(dtable, run_row, acc);
      run_row = r;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += edges.val[c][k >> 1][k & 1][f];
  }
  if (run_row != kNoRow && (!kSkipZero || nonzero(acc))) add_row<F>(dtable, run_row, acc);
}

// --- the 27-point lattice of a dedup level (HG5-HG8) -----------------------
// An aligned block of g samples of one ray's uniform-step run spans less
// than one cell of the level per axis, so every sample's 8 corners lie in
// the 3x3x3 lattice anchored at a = floor(min over the block of pos); the
// lattice point a + o (o in {0,1,2}^3, x fastest: j = o0 + 3 o1 + 9 o2)
// weighs a sample by the tent product prod_d max(0, 1 - |t_d - o_d|), t =
// pos - a (JAX ops/hashgrid.py _lattice_axis_tents / _lattice_w27,
// :274-293), and its row is clamped as a corner's (the weight stays with
// the unclamped point, so colliding clamped rows sum).

__device__ __forceinline__ float lattice_tent(float t, int o) {
  return fmaxf(0.0f, 1.0f - fabsf(t - static_cast<float>(o)));
}

// d tent / d t: +1 on [-1, 0), -1 on [0, 1), 0 elsewhere (right-continuous:
// at an integer t the per-sample path's right difference; JAX
// _lattice_axis_dtents, :296).
__device__ __forceinline__ float lattice_dtent(float t, int o) {
  const float u = t - static_cast<float>(o);
  return (u >= -1.0f && u < 0.0f) ? 1.0f : ((u >= 0.0f && u < 1.0f) ? -1.0f : 0.0f);
}

// The global row of lattice point a + o of level lv.
__device__ __forceinline__ uint32_t lattice_row(const HashLevel& lv, const int (&a)[3], int o0,
                                                int o1, int o2) {
  const int rmax = static_cast<int>(lv.res) - 1;
  const int o[3] = {o0, o1, o2};
  uint32_t cu[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int v = a[d] + o[d];
    cu[d] = static_cast<uint32_t>(v < 0 ? 0 : (v > rmax ? rmax : v));
  }
  const uint32_t local = lv.hashed
                             ? (cu[0] * 1u ^ cu[1] * 2654435761u ^ cu[2] * 805459861u) % lv.size
                             : cu[0] + cu[1] * lv.res + cu[2] * lv.res * lv.res;
  return local + lv.offset;
}

// The block's positions t = pos - a (G slots, the first g used) and its
// anchor a, from samples i0 .. i0 + g - 1: pos = fmaf(x, s, 0.5) as the
// per-sample taps round it.
template <int G>
__device__ __forceinline__ void lattice_block(const float* __restrict__ x, long long i0, int g,
                                              float scale, float (&t)[G][3], int (&a)[3]) {
  float mn[3] = {INFINITY, INFINITY, INFINITY};
#pragma unroll
  for (int s = 0; s < G; ++s) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      t[s][d] = s < g ? fmaf(x[3 * (i0 + s) + d], scale, 0.5f) : 0.0f;
      if (s < g) mn[d] = fminf(mn[d], t[s][d]);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float af = floorf(mn[d]);
    a[d] = static_cast<int>(af);
#pragma unroll
    for (int s = 0; s < G; ++s) t[s][d] = t[s][d] - af;
  }
}

// Bit o of axis d's mask: some sample of the block has a non-zero tent or
// tent derivative at lattice offset o on axis d. A lattice point outside the
// three masks weighs every sample by exact zeros in the features, the
// Jacobian, their updates and d x (every term holds a tent or a derivative
// of that axis), so skipping it leaves every sum as it is: they start at
// +0 and never hold -0, so adding a +-0 changes nothing.
template <int G>
__device__ __forceinline__ void lattice_masks(const float (&t)[G][3], int g, int (&mask)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    mask[d] = 0;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      if (s >= g) continue;
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        if (lattice_tent(t[s][d], o) != 0.0f || lattice_dtent(t[s][d], o) != 0.0f) {
          mask[d] |= 1 << o;
        }
      }
    }
  }
}

// The tents of lattice offset (o0, o1, o2) at t, their product (w_x w_y) w_z
// and, with dw, the product's gradient in grid units, (dw_d w_e1) w_e2 with
// e1 < e2 the other axes (JAX _lattice_wd27, :316).
struct LatticeWeights {
  float w[3], dw[3], w27, wd[3];
};

template <bool kGrad>
__device__ __forceinline__ LatticeWeights lattice_weights(const float (&t)[3], int o0, int o1,
                                                          int o2) {
  LatticeWeights r;
  const int o[3] = {o0, o1, o2};
#pragma unroll
  for (int d = 0; d < 3; ++d) r.w[d] = lattice_tent(t[d], o[d]);
  r.w27 = (r.w[0] * r.w[1]) * r.w[2];
  if constexpr (kGrad) {
#pragma unroll
    for (int d = 0; d < 3; ++d) r.dw[d] = lattice_dtent(t[d], o[d]);
    r.wd[0] = (r.dw[0] * r.w[1]) * r.w[2];
    r.wd[1] = (r.dw[1] * r.w[0]) * r.w[2];
    r.wd[2] = (r.dw[2] * r.w[0]) * r.w[1];
  }
  return r;
}

}  // namespace insr
