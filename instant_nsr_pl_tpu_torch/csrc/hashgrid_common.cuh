// Per-level helpers of the multiresolution hash grid, shared by HG1
// (csrc/hashgrid_fwd.cu) and HG2 (csrc/hashgrid_bwd.cu).
//
// The level layout is the JAX package's (instant_nsr_pl_tpu/ops/hashgrid.py
// HashGridSpec and _level_corner_indices, :44-222): per level a float32 scale
// s, a resolution R, a row count T_l and a row offset into the feature-major
// (F, total) float32 table; a dense level indexes x + y*R + z*R*R, a hashed
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
