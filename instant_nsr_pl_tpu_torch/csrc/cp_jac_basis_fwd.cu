// CP product with its analytic Jacobian and the basis projection fused (K9):
// enc (F, N) = B^T (v_x v_y v_z) and jac (3, F, N), jac_a = d enc / d u_a.
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py cp_product_jac_basis ->
// _cp_jacb_fwd_impl -> _jacb_fwd_kernel (pallas_call at :633), the NeuS
// analytic-gradient hot path (ops/cp.py cp_encode_with_jac): the SDF network's
// encoding and its Jacobian in one pass, so the eikonal loss's second-order
// graph never differentiates through this op (its backward is
// csrc/cp_jac_basis_bwd.cu). Training launches also write the TPU kernel's
// residuals vsave and gdsave (3, C, N) bf16; eval launches (a rendered view,
// under no_grad) write neither.
//
// What it computes, per sample u (3, N), axis a and component c, with the
// tent coordinates of cp_common.cuh on the (3, R, C) bf16 line stack L and
// the (C, F) bf16 basis B:
//   v_a  = w0 * L_a[i0] + w1 * L_a[i0 + 1]            (f32, one rounding)
//   gd_a = L_a[i0 + 1] - L_a[i0]                      (the exact diff-hot product)
//   g_a  = gd_a * s_a,   s_a = (R - 1) * d clip(u_a)/du_a (0.5 at exact 0 or 1)
//   enc[f]    = sum_c B[c][f] * bf16((v_x * v_y) * v_z)
//   jac_x[f]  = sum_c B[c][f] * bf16(g_x * (v_y * v_z)), and so on per axis
// with f32 sums: the TPU kernel's bf16-operand projection matmuls. gd is the
// right-derivative at an interior knot (i0 = floor(p)), as on the TPU.
//
// What bounds it on an H100: HBM. Per sample it reads u (12 B) and writes enc
// and jac (4 x F x 4 B = 256 B at F = 16), and in training mode vsave and gdsave
// (12 B x C = 768 B at C = 64): 268 B and 1,036 B, 21 us and 81 us at 3.35 TB/s
// for 262,144 samples. The projection is 4 x C x F = 4,096 multiply-adds per
// sample on the CUDA cores (~0.03 ms at 67 TFLOP/s f32). A thread per sample
// reads its 2 x 3 table rows with 16-byte loads, keeps the 4 x F projection
// sums in registers and reads B from shared memory as warp-wide broadcasts;
// stores are coalesced in the (F, N) and (C, N) layouts.
//
// Stacked scales (K11): the kernel is written for S scales that share one
// (3, R, S*C) bf16 table (row r holds every scale's C components side by
// side) and an (S, C, F) basis, with outputs enc (S*F, N), jac (3, S*F, N) and
// residuals (3, S*C, N). K9 is its S = 1 instantiation, launched once per
// scale. With S = 2 it replaces cp_pallas.py cp_jac_basis_stacked ->
// _cp_jacs_fwd_impl -> _jacs_fwd_kernel (pallas_call at :904): all scales
// upsampled onto the finest grid (ops/cp_stacked.py), one tent per axis at
// R_max, and the TPU's (E, S*C) block-diagonal projection computed as its S
// diagonal blocks: output block s sums components s*C .. s*C+C-1 only. The
// scales run one after the other, so the 4 x F projection sums stay in
// registers as in K9. Per sample the stacked kernel moves 12 B in, 512 B of enc
// and jac out and, training, 1,536 B of residuals (S*C = 128, F = 16).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "cp_common.cuh"

namespace insr {

constexpr int kJacBlock = 128;

template <int C, int F, int S>
__global__ void __launch_bounds__(kJacBlock)
    cp_jac_basis_fwd_kernel(const float* __restrict__ u3, long long n,
                            const __nv_bfloat16* __restrict__ lines, int r,
                            const __nv_bfloat16* __restrict__ basis,
                            float* __restrict__ enc, float* __restrict__ jac,
                            __nv_bfloat16* __restrict__ vsave,
                            __nv_bfloat16* __restrict__ gdsave) {
  static_assert(C % 8 == 0 && F % 4 == 0, "layout");
  constexpr int LD = S * C;  // row stride of the line table
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);  // (S, C, F)
  load_bf16_to_shared(basis, S * C * F, b_s);
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    Tent t[3];
    const uint4* row0[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      t[a] = tent(u3[a * n + i], r);
      row0[a] = reinterpret_cast<const uint4*>(
          lines + (static_cast<long long>(a) * r + t[a].i0) * LD);
    }
    // one scale (output block) at a time: components s*C .. s*C+C-1
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      float e[F], j0[F], j1[F], j2[F];
#pragma unroll
      for (int f = 0; f < F; ++f) e[f] = j0[f] = j1[f] = j2[f] = 0.0f;

#pragma unroll 1
      for (int c8 = 0; c8 < C / 8; ++c8) {
        uint4 q0[3], q1[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          q0[a] = __ldg(row0[a] + s * (C / 8) + c8);
          q1[a] = __ldg(row0[a] + LD / 8 + s * (C / 8) + c8);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = s * C + c8 * 8 + k;  // stacked component
          float v[3], g[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float lo = bf16_at(q0[a], k), hi = bf16_at(q1[a], k);
            v[a] = fmaf(t[a].w1, hi, t[a].w0 * lo);
            const float gd = hi - lo;
            g[a] = gd * t[a].s;
            if (vsave != nullptr) {
              const long long off = (static_cast<long long>(a) * LD + c) * n + i;
              vsave[off] = __float2bfloat16_rn(v[a]);
              gdsave[off] = __float2bfloat16_rn(gd);
            }
          }
          const float pr = bf16_round((v[0] * v[1]) * v[2]);
          const float p0 = bf16_round(g[0] * (v[1] * v[2]));
          const float p1 = bf16_round(g[1] * (v[0] * v[2]));
          const float p2 = bf16_round(g[2] * (v[0] * v[1]));
          const float4* brow = reinterpret_cast<const float4*>(b_s + c * F);
#pragma unroll
          for (int f4 = 0; f4 < F / 4; ++f4) {
            const float4 bv = brow[f4];
            const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int f = 4 * f4 + q;
              e[f] = fmaf(b[q], pr, e[f]);
              j0[f] = fmaf(b[q], p0, j0[f]);
              j1[f] = fmaf(b[q], p1, j1[f]);
              j2[f] = fmaf(b[q], p2, j2[f]);
            }
          }
        }
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const long long row = s * F + f;  // output row of this scale's block
        enc[row * n + i] = e[f];
        jac[row * n + i] = j0[f];
        jac[(S * F + row) * n + i] = j1[f];
        jac[(2 * S * F + row) * n + i] = j2[f];
      }
    }
  }
}

template <int C, int F, int S>
int launch_jac_basis(const float* u3, long long n, const void* lines, int r,
                     const void* basis, float* enc, float* jac, void* vsave, void* gdsave,
                     cudaStream_t stream) {
  return launch(cp_jac_basis_fwd_kernel<C, F, S>, n, kJacBlock, sizeof(float) * S * C * F,
                stream,
                u3, n, static_cast<const __nv_bfloat16*>(lines), r,
                static_cast<const __nv_bfloat16*>(basis), enc, jac,
                static_cast<__nv_bfloat16*>(vsave), static_cast<__nv_bfloat16*>(gdsave));
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape. vsave and gdsave are both nullptr (eval) or both the
// (3, C, N) bf16 residuals (training).
extern "C" int cp_jac_basis_fwd(const float* u3, long long n, const void* lines, int r,
                                int c, int f, const void* basis, float* enc, float* jac,
                                void* vsave, void* gdsave, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACB_CASE(C_, F_)                                                   \
  if (c == C_ && f == F_)                                                        \
    return insr::launch_jac_basis<C_, F_, 1>(u3, n, lines, r, basis, enc, jac, vsave, \
                                             gdsave, st);
  INSR_JACB_CASE(128, 16)  // the bench NeuS SDF encoding at bench.py --encoding cp_big
  INSR_JACB_CASE(64, 16)   // the bench NeuS SDF encoding
  INSR_JACB_CASE(16, 8)   // the small test model
#undef INSR_JACB_CASE
  return -1;
}

// K11, the stacked-scales forward: `lines` is the (3, R_max, S*C) bf16 fine
// table, r = R_max, `basis` the (S, C, F) bf16 diagonal blocks; outputs enc
// (S*F, N), jac (3, S*F, N) and, training, the (3, S*C, N) bf16 residuals.
extern "C" int cp_jac_stacked_fwd(const float* u3, long long n, const void* lines, int r,
                                  int c, int f, int n_scales, const void* basis, float* enc,
                                  float* jac, void* vsave, void* gdsave, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACS_CASE(C_, F_, S_)                                                  \
  if (c == C_ && f == F_ && n_scales == S_)                                         \
    return insr::launch_jac_basis<C_, F_, S_>(u3, n, lines, r, basis, enc, jac, vsave, \
                                              gdsave, st);
  INSR_JACS_CASE(64, 16, 2)  // the bench NeuS SDF encoding, cp_stacked
  INSR_JACS_CASE(16, 8, 2)   // the small test model
#undef INSR_JACS_CASE
  return -1;
}
