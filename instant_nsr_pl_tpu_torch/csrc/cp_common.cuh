// Per-axis device helpers of the CP line encoding, shared by the fused density
// kernels (csrc/cp_mlp_fwd.cu K1, csrc/cp_mlp_bwd.cu K2) and the CP product
// kernels (csrc/cp_product_fwd.cu K5, csrc/cp_product_jac_fwd.cu K7,
// csrc/cp_jac_basis_{fwd,bwd}.cu K9/K10 and, in the backward's source, K6 and
// K8).
//
// Replaces the operand builders of instant_nsr_pl_tpu/ops/cp_pallas.py:94-126:
// _axis_p, _tent, _diffhot and _inrange_half. The TPU kernels build a dense
// (R, BN) tent or diff-hot operand per axis and multiply it on the MXU; each
// column has exactly two non-zeros, at rows i0 and i0 + 1, so on the card a
// thread reads those two table rows (16-byte loads) and weights them:
//   p  = clip(u, 0, 1) * (R - 1),  i0 = min(floor(p), R - 2)
//   tent:     w_r = bf16(max(0, 1 - |r - p|))  for r in {i0, i0 + 1},
//             with r - p = fma(-clip(u), R - 1, r), rounded once, as the
//             JAX package's compiled kernel contracts it
//   diff-hot: -1 at i0, +1 at i0 + 1 (exact in bf16)
//   d clip(u)/du: 0 outside [0, 1], 0.5 at exactly 0 or 1, else 1
// Both tent weights are computed as the TPU kernel computes them, 1 - |r - p|
// in f32, not as 1 - f and f: for i0 = 0 and p < 0.5, 1 - (1 - p) can differ
// from p by an ulp. Every table value and tent weight is bf16, so each
// weighted row value is exact in f32 and the two-term sum rounds once, as the
// MXU's f32 accumulation does. Build with --fmad=false and use fmaf only
// where the plain version also rounds once.
#pragma once

#include <cstdint>

#include "mlp_common.cuh"

namespace insr {

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Element k (0..7) of eight packed bf16 values.
__device__ __forceinline__ float bf16_at(const uint4& q, int k) {
  const uint32_t w = k < 2 ? q.x : k < 4 ? q.y : k < 6 ? q.z : q.w;
  return (k & 1) ? bf16_hi(w) : bf16_lo(w);
}

// The tent coordinates of one clipped coordinate u on an R-row table.
struct Tent {
  int i0;     // first of the two rows
  float w0;   // bf16 tent weight of row i0
  float w1;   // bf16 tent weight of row i0 + 1
  float s;    // (R - 1) * d clip(u)/du, the scale of the diff-hot derivative
};

__device__ __forceinline__ float inrange_half(float u) {
  if (u < 0.0f || u > 1.0f) return 0.0f;
  if (u == 0.0f || u == 1.0f) return 0.5f;
  return 1.0f;
}

__device__ __forceinline__ Tent tent(float u, int r) {
  const float rm1 = static_cast<float>(r - 1);
  const float cu = fminf(fmaxf(u, 0.0f), 1.0f);
  const float i0 = fminf(floorf(cu * rm1), static_cast<float>(r - 2));
  Tent t;
  t.i0 = static_cast<int>(i0);
  t.w0 = bf16_round(fmaxf(0.0f, 1.0f - fabsf(fmaf(-cu, rm1, i0))));
  t.w1 = bf16_round(fmaxf(0.0f, 1.0f - fabsf(fmaf(-cu, rm1, i0 + 1.0f))));
  t.s = rm1 * inrange_half(u);
  return t;
}

// 16-byte atomic add (Hopper, CUDA >= 12.1), else four 4-byte atomics.
__device__ __forceinline__ void atomic_add4(float* dst, float a, float b, float c,
                                            float d) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(a, b, c, d));
#else
  atomicAdd(dst, a);
  atomicAdd(dst + 1, b);
  atomicAdd(dst + 2, c);
  atomicAdd(dst + 3, d);
#endif
}

}  // namespace insr
