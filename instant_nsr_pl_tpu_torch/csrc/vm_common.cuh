// Shared pieces of the VM encoding's kernels, VM1 (csrc/vm_fwd.cu) and VM2
// (csrc/vm_bwd.cu): the table records, the taps of one plane and its line
// (ops/vm.py _plane_taps / _line_taps) and the lane layout.
//
// Layout: a group of C / 4 lanes holds one sample's row of C floats, a
// float4 a lane (a 64-byte row is 4 lanes at C = 16), so one warp load,
// store or atomic moves 32 / (C / 4) whole rows in whole 32-byte sectors.
// A warp works on one plane j = 3 s + k (scale s, plane k) at a time, so its
// rows come from one plane and one line table; warps are numbered sample
// tile first, plane second, so the card works on every plane at once.

#pragma once

#include <cuda_runtime.h>

namespace insr {

constexpr int kVMMaxJ = 12;  // 3 planes x up to 4 scales (ops/vm.py MAX_SCALES)
constexpr int kVMBlock = 128;  // threads a block: 4 warps, each on its own (tile, plane)

// Lanes a sample's row takes, and samples a warp holds at once
template <int C>
struct VMLanes {
  static constexpr int kLanes = C / 4;
  static constexpr int kGroups = 32 / kLanes;
};

// Per plane j: its plane (R_j^2, C) and line (R_l, C) tables, row-major
// float32, or their gradients, and the plane's resolution R_j. Passed by
// value to the kernels.
struct VMTables {
  const float* plane[kVMMaxJ];
  const float* line[kVMMaxJ];
  int plane_res[kVMMaxJ];
};

// plane k = j % 3 pairs axes (a, b); its line runs along c
__device__ __forceinline__ void vm_axes(int k, int& a, int& b, int& c) {
  a = k == 2 ? 1 : 0;
  b = k == 0 ? 1 : 2;
  c = k == 0 ? 2 : (k == 1 ? 1 : 0);
}

// u -> (i0, w1): p = clip(u, 0, 1) * (res - 1), i0 = clip(floor(p), 0,
// res - 2), w1 = p - i0 (ops/vm.py _interp_rows_weights_1d)
__device__ __forceinline__ void vm_interp(float u, int res, int& i0, float& w1) {
  const float uc = fminf(fmaxf(u, 0.0f), 1.0f);
  const float p = uc * static_cast<float>(res - 1);
  int i = static_cast<int>(floorf(p));
  i = i < 0 ? 0 : (i > res - 2 ? res - 2 : i);
  i0 = i;
  w1 = p - static_cast<float>(i);
}

// xs[d] for a d known only at run time, without indexing into local memory
__device__ __forceinline__ float vm_pick(const float* xs, int d) {
  return d == 0 ? xs[0] : (d == 1 ? xs[1] : xs[2]);
}

struct VMTaps {
  int prow[4];  // plane rows (ia0 ib0, ia0 ib1, ia1 ib0, ia1 ib1)
  float pw[4];
  int lrow0;  // line rows lrow0, lrow0 + 1
  float lw[2];
  float wa, wb;  // the plane's cell fractions along a and b
  int a, b, c;
};

__device__ __forceinline__ VMTaps vm_taps(const float* __restrict__ xs, int k, int res,
                                         int line_res) {
  VMTaps t;
  vm_axes(k, t.a, t.b, t.c);
  int ia, ib;
  vm_interp(vm_pick(xs, t.a), res, ia, t.wa);
  vm_interp(vm_pick(xs, t.b), res, ib, t.wb);
  t.prow[0] = ia * res + ib;
  t.prow[1] = ia * res + ib + 1;
  t.prow[2] = (ia + 1) * res + ib;
  t.prow[3] = (ia + 1) * res + ib + 1;
  const float ua = 1.0f - t.wa, ub = 1.0f - t.wb;
  t.pw[0] = ua * ub;
  t.pw[1] = ua * t.wb;
  t.pw[2] = t.wa * ub;
  t.pw[3] = t.wa * t.wb;
  float wl;
  vm_interp(vm_pick(xs, t.c), line_res, t.lrow0, wl);
  t.lw[0] = 1.0f - wl;
  t.lw[1] = wl;
  return t;
}

__device__ __forceinline__ float4 ld4(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

__device__ __forceinline__ float4 add4(float4 u, float4 v) {
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

__device__ __forceinline__ float4 mul4(float4 u, float4 v) {
  return make_float4(u.x * v.x, u.y * v.y, u.z * v.z, u.w * v.w);
}

// The float4 at component q of the 6 tap rows: all six loads in flight
// before any arithmetic
__device__ __forceinline__ void vm_rows(const float* __restrict__ plane,
                                        const float* __restrict__ line, const VMTaps& t, int C,
                                        int q, float4 (&prow)[4], float4 (&lrow)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) prow[i] = ld4(plane + static_cast<long long>(t.prow[i]) * C + q);
  lrow[0] = ld4(line + static_cast<long long>(t.lrow0) * C + q);
  lrow[1] = ld4(line + static_cast<long long>(t.lrow0 + 1) * C + q);
}

// Four components [q, q + 4) of the plane and line features from the tap
// rows: the taps summed in order, each product rounded before its sum (built
// with --fmad=false)
__device__ __forceinline__ void vm_features(const VMTaps& t, const float4 (&prow)[4],
                                            const float4 (&lrow)[2], float4& pf, float4& lf) {
  pf = scale4(prow[0], t.pw[0]);
#pragma unroll
  for (int i = 1; i < 4; ++i) pf = add4(pf, scale4(prow[i], t.pw[i]));
  lf = add4(scale4(lrow[0], t.lw[0]), scale4(lrow[1], t.lw[1]));
}

}  // namespace insr
