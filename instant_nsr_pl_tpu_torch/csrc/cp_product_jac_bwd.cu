// Backward of the CP product with its analytic Jacobian, no basis (K8):
// (d prod (C, N), d jac (3, C, N)) -> (d lines (3, R, C), d u (3, N)).
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py _cp_product_jac_bwd ->
// _jac_bwd_kernel (pallas_call at :464). It reads the forward's bf16 residuals
// vsave and gdsave (3, C, N) (csrc/cp_product_jac_fwd.cu training mode), never
// the tables, and follows the TPU kernel's rounding points. Per sample and
// component, with s_a = (R - 1) * d clip(u_a)/du_a, other_a = product of the
// other two axes' v and (b, c) the other two axes of a:
//   gs_a   = (dJ_a * gd_a) * s_a
//   d v_a  = (dP * other_a + gs_b * v_c) + gs_c * v_b
//   d gd_a = (dJ_a * s_a) * other_a
//   d u_a  = (sum_C d v_a * gd_a) * s_a                   (the f32 d v)
//   dL_a[i0]     += w0 * bf16(d v_a) - bf16(d gd_a)
//   dL_a[i0 + 1] += w1 * bf16(d v_a) + bf16(d gd_a)
// with dP and dJ the f32 cotangents as given. The last two lines are the TPU's
// dense bf16(d v) x tent^T + bf16(d gd) x diff-hot^T matmuls restricted to
// their two non-zero rows. K8 is K10 (csrc/cp_jac_basis_bwd.cu) without the
// basis: no projection of the cotangents and no d B, so no shared memory.
//
// Cross-sample sums: the TPU accumulates the (3, C, R) table gradient in VMEM
// across its sequential grid. Here blocks run in no order and the rows a
// sample touches depend on the data: each sample adds its two rows per axis
// straight to the (3, R, C) f32 output with 16-byte vector atomics (C / 4 per
// row), as csrc/cp_product_bwd.cu (K6) does. The summation order changes from
// run to run, so results agree with the plain version to f32 rounding of the
// sums, not to the bit.
//
// What bounds it on an H100: HBM. Per sample it reads u (12 B), vsave and
// gdsave (12 B x C), d prod (4 B x C) and d jac (12 B x C), and writes d u
// (12 B): 1,816 B at C = 64, 142 us at 3.35 TB/s for 262,144 samples, plus the
// (3, R, C) f32 table gradient once. This first version makes 6 x C / 4
// vector atomics per sample (96 at C = 64) into tables that stay in L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "cp_common.cuh"

namespace insr {

constexpr int kProdJacBwdBlock = 128;

template <int C>
__global__ void __launch_bounds__(kProdJacBwdBlock)
    cp_product_jac_bwd_kernel(const float* __restrict__ u3, long long n, int r,
                              const __nv_bfloat16* __restrict__ vsave,
                              const __nv_bfloat16* __restrict__ gdsave,
                              const float* __restrict__ dprod, const float* __restrict__ djac,
                              float* __restrict__ dlines, float* __restrict__ du) {
  static_assert(C % 4 == 0, "rows are scattered in groups of 4");
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    Tent t[3];
    float* drow0[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      t[a] = tent(u3[a * n + i], r);
      drow0[a] = dlines + (static_cast<long long>(a) * r + t[a].i0) * C;
    }
    float acc_u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int c4 = 0; c4 < C / 4; ++c4) {
      float dvr[3][4], dgr[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long c = 4 * c4 + q;
        float v[3], gd[3], dj[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const long long off = (a * C + c) * n + i;
          v[a] = __bfloat162float(vsave[off]);
          gd[a] = __bfloat162float(gdsave[off]);
          dj[a] = djac[off];
        }
        const float dp = dprod[c * n + i];
        const float other[3] = {v[1] * v[2], v[0] * v[2], v[0] * v[1]};
        float gs[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) gs[a] = (dj[a] * gd[a]) * t[a].s;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int b1 = a == 0 ? 1 : 0;
          const int b2 = a == 2 ? 1 : 2;
          const float d_v = (dp * other[a] + gs[b1] * v[b2]) + gs[b2] * v[b1];
          const float d_gd = (dj[a] * t[a].s) * other[a];
          acc_u[a] = acc_u[a] + d_v * gd[a];
          dvr[a][q] = bf16_round(d_v);
          dgr[a][q] = bf16_round(d_gd);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float* dst = drow0[a] + 4 * c4;
        const float w0 = t[a].w0, w1 = t[a].w1;
        atomic_add4(dst, w0 * dvr[a][0] - dgr[a][0], w0 * dvr[a][1] - dgr[a][1],
                    w0 * dvr[a][2] - dgr[a][2], w0 * dvr[a][3] - dgr[a][3]);
        atomic_add4(dst + C, w1 * dvr[a][0] + dgr[a][0], w1 * dvr[a][1] + dgr[a][1],
                    w1 * dvr[a][2] + dgr[a][2], w1 * dvr[a][3] + dgr[a][3]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) du[a * n + i] = acc_u[a] * t[a].s;
  }
}

template <int C>
int launch_product_jac_bwd(const float* u3, long long n, int r, const void* vsave,
                           const void* gdsave, const float* dprod, const float* djac,
                           float* dlines, float* du, cudaStream_t stream) {
  return launch(cp_product_jac_bwd_kernel<C>, n, kProdJacBwdBlock, 0, stream, u3, n, r,
                static_cast<const __nv_bfloat16*>(vsave),
                static_cast<const __nv_bfloat16*>(gdsave), dprod, djac, dlines, du);
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape. dlines must be zeroed by the caller: the kernel adds
// into it.
extern "C" int cp_product_jac_bwd(const float* u3, long long n, int r, int c,
                                  const void* vsave, const void* gdsave, const float* dprod,
                                  const float* djac, float* dlines, float* du, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 128)  // the raw products at bench.py --encoding cp_big's C
    return insr::launch_product_jac_bwd<128>(u3, n, r, vsave, gdsave, dprod, djac, dlines, du, st);
  if (c == 64)  // the raw-product NeuS SDF encoding
    return insr::launch_product_jac_bwd<64>(u3, n, r, vsave, gdsave, dprod, djac, dlines, du, st);
  if (c == 16)  // the small test model
    return insr::launch_product_jac_bwd<16>(u3, n, r, vsave, gdsave, dprod, djac, dlines, du, st);
  return -1;
}
