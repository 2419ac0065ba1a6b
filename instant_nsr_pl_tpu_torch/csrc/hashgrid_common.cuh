// Per-level helpers of the multiresolution hash grid, shared by HG1
// (csrc/hashgrid_fwd.cu), HG2 (csrc/hashgrid_bwd.cu), HG3
// (csrc/hashgrid_jac_fwd.cu) and HG4 (csrc/hashgrid_jac_bwd.cu): the taps of a
// level, the row loads, the corner partials of the Jacobian, the vector
// stores, and the table-gradient scatter that HG2 and HG4 instantiate with
// their own cotangents (hash_scatter).
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

#include <cstdint>

#include <cuda_runtime.h>

namespace insr {

constexpr int kHashMaxLevels = 32;
constexpr int kHashBlock = 128;

struct HashLevel {
  float scale;
  uint32_t res;
  uint32_t size;
  uint32_t offset;
  int hashed;
};

struct HashLevels {
  HashLevel l[kHashMaxLevels];
};

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

// Row `row` of the row-major (T, F) float32 table: one vector load (8 bytes
// at F = 2, a quarter of one 32-byte sector).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, uint32_t row,
                                         float (&v)[F]) {
  const float* p = table + static_cast<long long>(row) * F;
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

// Store M floats to dst: float4 / float2 pieces when M allows them (the
// caller passes a dst aligned to 4 * M bytes, up to 16).
template <int M>
__device__ __forceinline__ void store_vec(float* __restrict__ dst, const float (&v)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int k = 0; k < M; k += 4) {
      reinterpret_cast<float4*>(dst)[k / 4] = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int k = 0; k < M; k += 2) {
      reinterpret_cast<float2*>(dst)[k / 2] = make_float2(v[k], v[k + 1]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < M; ++k) dst[k] = v[k];
  }
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

// The scatter of HG2 and HG4: one thread per sample, a warp on 32 consecutive
// samples, walks the levels, recomputes its 8 taps and adds each corner's
// update, summed over runs of equal rows, into the zeroed row-major (T, F)
// gradient (the design and its measurements: csrc/hashgrid_bwd.cu):
// - within the warp, a segmented scan over each run of lanes with equal rows
//   (a ray's neighbouring samples on a coarse level) sums the run in a fixed
//   order, and the run's last lane adds it with one vector atomic;
// - each warp's first and last run of a level go to shared memory, and after
//   the level one thread per corner walks the block's warps in order, sums
//   the runs that hold the same row and adds each merged run once.
// With dx requested each thread also adds its levels' position gradient in
// registers, in a fixed order. The cotangent policy Cot says what a sample
// brings to a level (Cot::Level, from Cot::load: zeros for an idle lane), the
// update of corner c (Cot::update) and the level's position-gradient term
// (Cot::dx). Must be called by whole blocks of kHashBlock threads.
template <int F, class Cot>
__device__ __forceinline__ void hash_scatter(const float* __restrict__ x, long long n,
                                             const Cot& cot, const float* __restrict__ table,
                                             int n_levels, const HashLevels& levels,
                                             const float* __restrict__ mask,
                                             float* __restrict__ dtable, float* __restrict__ dx) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr uint32_t kNoRow = 0xffffffffu;  // an idle lane's row, and an empty edge slot
  constexpr int kWarps = kHashBlock / 32;
  // per level and corner, each warp's first run [0] and last run [1] (row,
  // sum); two buffers, so one barrier per level suffices
  __shared__ uint32_t edge_row[2][8][kWarps][2];
  __shared__ float edge_val[2][8][kWarps][2][F];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int buf = 0;
  // block-uniform loop (the barriers below); each warp on 32 consecutive samples
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool active = i < n;
    const long long ii = active ? i : n - 1;  // a valid address for idle lanes
    const float x0 = x[3 * ii], x1 = x[3 * ii + 1], x2 = x[3 * ii + 2];
    float dxa[3] = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < n_levels; ++l, buf ^= 1) {
      const HashLevel& lv = levels.l[l];
      const Taps t = level_taps(lv, x0, x1, x2);
      const float m = mask != nullptr ? mask[l] : 1.0f;
      const typename Cot::Level g = cot.load(ii, l, n_levels, active, mask != nullptr, m);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t row = active ? t.row[c] : kNoRow;
        float v[F];
        cot.update(g, t, c, lv.scale, v);
        const uint32_t left = __shfl_up_sync(kAll, row, 1);
        const bool head = lane == 0 || left != row;  // the first lane of a run of equal rows
        const unsigned heads = __ballot_sync(kAll, head);
        if (heads != kAll) {
          // a segmented inclusive scan over each run of lanes: afterwards the
          // run's last lane holds the run's sum, taken in a fixed order
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
        // run ends: lane 31 and every lane before a head; the warp's first
        // run ends at the lowest of them, its last at lane 31
        const unsigned tails = (heads >> 1) | 0x80000000u;
        const int first_end = __ffs(tails) - 1;
        const bool tail = (tails >> lane) & 1u;
        if (lane == first_end || lane == 31) {
          const int k = lane == first_end ? 0 : 1;
          edge_row[buf][c][warp][k] = row;
#pragma unroll
          for (int f = 0; f < F; ++f) edge_val[buf][c][warp][k][f] = v[f];
          if (first_end == 31) edge_row[buf][c][warp][1] = kNoRow;  // one run: no last run
        } else if (tail && active) {
          add_row<F>(dtable, row, v);
        }
      }
      __syncthreads();  // every warp's edge runs of this level are staged
      if (threadIdx.x < 8) {
        // corner threadIdx.x: the block's edge runs in warp order, equal rows summed
        const int c = threadIdx.x;
        uint32_t run_row = kNoRow;
        float acc[F];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.0f;
        for (int k = 0; k < 2 * kWarps; ++k) {
          const uint32_t r = edge_row[buf][c][k >> 1][k & 1];
          if (r == kNoRow) continue;
          if (r != run_row) {
            if (run_row != kNoRow) add_row<F>(dtable, run_row, acc);
            run_row = r;
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = 0.0f;
          }
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] += edge_val[buf][c][k >> 1][k & 1][f];
        }
        if (run_row != kNoRow) add_row<F>(dtable, run_row, acc);
      }
      if (dx != nullptr) cot.dx(g, t, table, lv.scale, dxa);
    }
    if (dx != nullptr && active) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dx[3 * i + d] = dxa[d];
    }
  }
}

// Grid of a grid-stride launch: enough blocks to fill every SM a few times.
inline int hash_grid_for(long long n) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n + kHashBlock - 1) / kHashBlock;
  const long long cap = 16LL * sms;
  return static_cast<int>(need < cap ? (need > 0 ? need : 1) : cap);
}

}  // namespace insr
