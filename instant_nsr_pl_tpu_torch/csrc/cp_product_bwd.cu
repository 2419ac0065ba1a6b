// CP line product backward (K6): (d prod) -> (d lines (3, R, C), d u (3, N)).
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py _cp_product_bwd -> _bwd_kernel
// (pallas_call at :277). It reads the forward's bf16 residual vsave (3, C, N)
// (csrc/cp_product_fwd.cu training mode) and, at the TPU kernel's rounding
// points, computes per sample and axis a, with b, c the other two axes:
//   d_v_a[c] = dp[c] * (v_b[c] * v_c[c])                      (f32)
//   gd_a[c]  = L_a[i0 + 1][c] - L_a[i0][c]  from the bf16 table (f32)
//   du_a     = (sum_c d_v_a[c] * gd_a[c]) * (R - 1) * d clip(u_a)/du_a
//   dL_a[i0][c] += w0 * bf16(d_v_a[c]),  dL_a[i0 + 1][c] += w1 * bf16(d_v_a[c])
// with i0, w0, w1 the tent coordinates of cp_common.cuh. The TPU computes the
// table gradient as the dense bf16(d_v) x tent^T matmul; the tent has two
// non-zeros per sample, so the scatter of the two weighted rows is the same
// sum. d u uses the f32 d_v, as the TPU kernel does.
//
// Cross-sample sums: the TPU accumulates the (3, C, R) table gradient in VMEM
// across its sequential grid. Here blocks run in no order, and the rows a
// sample touches depend on the data: each sample adds its two weighted rows
// per axis straight to the (3, R, C) f32 output with 16-byte vector atomics
// (C / 4 per row). The summation order then changes from run to run, so the
// result agrees with the plain version to f32 rounding of the sums, not to the
// bit.
//
// What bounds it on an H100: HBM. The function reads u (12 B), vsave (6 B x C)
// and dp (4 B x C) and writes du (12 B) per sample, 664 B at C = 64, about
// 52 us at 3.35 TB/s for 262,144 samples, plus the (3, R, C) f32 table
// gradient once. This first version issues 6 x C / 4 vector atomics per
// sample (96 at C = 64) into tables that stay in L2; a shared-memory
// pre-reduction for the coarse scale is left for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "cp_common.cuh"

namespace insr {

constexpr int kProdBwdBlock = 128;

template <int C>
__global__ void __launch_bounds__(kProdBwdBlock)
    cp_product_bwd_kernel(const float* __restrict__ u3, long long n,
                          const __nv_bfloat16* __restrict__ lines, int r,
                          const __nv_bfloat16* __restrict__ vsave,
                          const float* __restrict__ dprod, float* __restrict__ dlines,
                          float* __restrict__ du) {
  static_assert(C % 4 == 0, "rows are read and scattered in groups of 4");
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    Tent t[3];
    const uint2* row0[3];
    float* drow0[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      t[a] = tent(u3[a * n + i], r);
      const long long off = (static_cast<long long>(a) * r + t[a].i0) * C;
      row0[a] = reinterpret_cast<const uint2*>(lines + off);
      drow0[a] = dlines + off;
    }
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int c4 = 0; c4 < C / 4; ++c4) {
      float gd[3][4], dv[3][4];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const uint2 q0 = __ldg(row0[a] + c4);
        const uint2 q1 = __ldg(row0[a] + C / 4 + c4);
        gd[a][0] = bf16_lo(q1.x) - bf16_lo(q0.x);
        gd[a][1] = bf16_hi(q1.x) - bf16_hi(q0.x);
        gd[a][2] = bf16_lo(q1.y) - bf16_lo(q0.y);
        gd[a][3] = bf16_hi(q1.y) - bf16_hi(q0.y);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long c = 4 * c4 + q;
        float v[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = __bfloat162float(vsave[(a * C + c) * n + i]);
        const float dp = dprod[c * n + i];
        dv[0][q] = dp * (v[1] * v[2]);
        dv[1][q] = dp * (v[0] * v[2]);
        dv[2][q] = dp * (v[0] * v[1]);
#pragma unroll
        for (int a = 0; a < 3; ++a) acc[a] = acc[a] + dv[a][q] * gd[a][q];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float d0 = bf16_round(dv[a][0]), d1 = bf16_round(dv[a][1]);
        const float d2 = bf16_round(dv[a][2]), d3 = bf16_round(dv[a][3]);
        float* dst = drow0[a] + 4 * c4;
        if (t[a].w0 != 0.0f) {
          atomic_add4(dst, t[a].w0 * d0, t[a].w0 * d1, t[a].w0 * d2, t[a].w0 * d3);
        }
        if (t[a].w1 != 0.0f) {
          atomic_add4(dst + C, t[a].w1 * d0, t[a].w1 * d1, t[a].w1 * d2, t[a].w1 * d3);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) du[a * n + i] = acc[a] * t[a].s;
  }
}

template <int C>
int launch_product_bwd(const float* u3, long long n, const void* lines, int r,
                       const void* vsave, const float* dprod, float* dlines, float* du,
                       cudaStream_t stream) {
  return launch(cp_product_bwd_kernel<C>, n, kProdBwdBlock, 0, stream, u3, n,
                static_cast<const __nv_bfloat16*>(lines), r,
                static_cast<const __nv_bfloat16*>(vsave), dprod, dlines, du);
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape. dlines must be zeroed by the caller: the kernel adds
// into it.
extern "C" int cp_product_bwd(const float* u3, long long n, const void* lines, int r, int c,
                              const void* vsave, const float* dprod, float* dlines,
                              float* du, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 128) return insr::launch_product_bwd<128>(u3, n, lines, r, vsave, dprod, dlines, du, st);
  if (c == 64) return insr::launch_product_bwd<64>(u3, n, lines, r, vsave, dprod, dlines, du, st);
  if (c == 16) return insr::launch_product_bwd<16>(u3, n, lines, r, vsave, dprod, dlines, du, st);
  return -1;
}
